"""Weights and the program under test, from a configuration file.

The benchmark makes or loads the weights itself and hands the same tensors
to both sides: the program's modules get them through load_state_dict, the
reference as plain dicts (reference/cvpr.py's layouts). Seeded weights are
drawn on the device with one torch.Generator, one call for all the context
model's kernels.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from perfbench import harness
from perfbench.reference import cvpr as ref

PC_LAYERS = (('conv0', True), ('res1.conv1', False), ('res1.conv2', False), ('conv_out', False))


class Weights(NamedTuple):
    ae: Dict      # reference layout, on the device
    pc: Dict


def pc_shapes(cfg: Dict):
    m = cfg['model']
    k, f, L = m['kernel_size'], m['arch_param__k'], m['num_centers']
    kd = k // 2 + 1
    cins = (1, f, f, f)
    couts = (f, f, f, L)
    return [(name, (cout, cin, kd, k, k)) for (name, _), cin, cout in zip(PC_LAYERS, cins, couts)]


def seeded_pc(cfg: Dict, seed: int, device) -> Dict:
    """Glorot-uniform context-model kernels (fan over cin kd k k and cout kd
    k k) and zero biases from ``seed``, drawn on ``device`` in one call."""
    import torch
    shapes = pc_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s in shapes]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    out, off = {}, 0
    for (name, s), n in zip(shapes, sizes):
        rf = int(np.prod(s[2:]))
        out[name + '.w'] = (u[off:off + n] * ref.glorot_limit(s[1] * rf, s[0] * rf)).reshape(s)
        out[name + '.b'] = torch.zeros(s[0], device=device)
        off += n
    return out


def load_weights(cfg: Dict, device) -> Weights:
    w = cfg['weights']
    path = harness.check_file(w['npz'], w['sha256'])
    ae, pc = ref.load_npz(path, device)
    if 'pc_seed' in w:
        pc = seeded_pc(cfg, w['pc_seed'], device)
    return Weights(ae, pc)


def ae_state_dict(ae_ref: Dict) -> Dict:
    """Reference AE layout -> the port's CVPRAutoencoder state dict."""
    sd = {}
    for k, v in ae_ref.items():
        mod, leaf = k.rsplit('.', 1)
        if leaf == 'centers':
            sd[k] = v
        elif leaf == 'w':
            sd[mod + '.weight'] = v
        else:
            sd[mod + '.bn_' + leaf] = v
    return sd


def pc_state_dict(pc_ref: Dict) -> Dict:
    return {'net.' + k.rsplit('.', 1)[0] + ('.weight' if k.endswith('.w') else '.bias'): v
            for k, v in pc_ref.items()}


DTYPES = {'f32': 'float32', 'bf16': 'bfloat16'}


class Program(NamedTuple):
    ae: object          # imgcomp_cvpr_tpu_torch CVPRAutoencoder
    pc: object          # ProbClassifier
    codec: object       # LatentCodec
    centers: np.ndarray  # (L,) host float32


def build_program(cfg: Dict, weights: Weights, device, ae_dtype: str) -> Program:
    """The port's modules for ``cfg`` with ``weights``, its configuration
    held to the file's ``model`` keys."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    ae_config, _ = config_lib.parse_spec(cfg['ae_spec'], 'ae')
    pc_config, _ = config_lib.parse_spec(cfg['pc_spec'], 'pc')
    for key, want in cfg['model'].items():
        have = ae_config.get(key) if key in ae_config else pc_config.get(key, 'missing')
        if have != want and not (isinstance(want, list) and list(have) == want):
            raise RuntimeError(f'config {cfg["name"]}: {key} is {have!r} in the program, '
                               f'{want!r} in the file')
    ae = ae_lib.CVPRAutoencoder(ae_config, device=device, dtype=getattr(torch, DTYPES[ae_dtype]))
    pc = pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device=device)
    ae.load_state_dict(ae_state_dict(weights.ae), strict=True)
    pc.load_state_dict(pc_state_dict(weights.pc), strict=True)
    codec = codec_lib.LatentCodec(pc, pc_config, device=device, prec=cfg['serve']['codec_prec'])
    return Program(ae, pc, codec, ae.encoder.centers.detach().cpu().numpy().astype(np.float32))
