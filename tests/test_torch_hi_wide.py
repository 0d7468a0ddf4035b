"""The widest published pairing on the CPU, `ae cvpr/hi` (C=64) with
`pc cvpr/res_shallow_64` (kf=64), on seeded random weights at a small size:
the port's AE and context model against the benchmark's plain reference
(perfbench/reference/cvpr.py, float32), and a LatentCodec round trip
through the plain versions of kernels 2 and 3, its theoretical bits held to
the reference's. The weights reach both sides through the checkpoint
export (tools/ckpt_mapper.export_npz) and the reference's own npz reader."""

import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
from imgcomp_cvpr_tpu_torch.tools import ckpt_mapper
from imgcomp_cvpr_tpu_torch.utils import config as config_lib
from perfbench.reference import cvpr as ref

SHAPE = (2, 32, 48)     # images (B, H, W): latent (64, 4, 6)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def wide(tmp_path_factory):
    """(ae, pc, pc_config, ref AE params, ref PC params): the port's modules
    with random weights and BatchNorm statistics, and the same weights as
    the reference reads them from the exported npz."""
    ae_config, _ = config_lib.parse_spec('cvpr/hi', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow_64', 'pc')
    assert (ae_config.num_chan_bn, pc_config.arch_param__k, pc_config.kernel_size) == (64, 64, 3)
    ae = ae_lib.init_params(ae_lib.CVPRAutoencoder(ae_config, device='cpu'), 20)
    pc = pc_lib.init_params(pc_lib.ProbClassifier(pc_config, ae_config.num_centers,
                                                  device='cpu'), 21)
    g = torch.Generator().manual_seed(22)
    with torch.no_grad():
        for name, t in ae.state_dict().items():
            if name.endswith('bn_var'):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(('bn_mean', 'bn_bias')):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith('bn_scale'):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
        for name, t in pc.state_dict().items():
            if name.endswith('bias'):
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    d = tmp_path_factory.mktemp('hi_wide')
    torch.save({'model': {'ae': ae.state_dict(), 'pc': pc.state_dict()}}, d / 'ckpt-1')
    ckpt_mapper.export_npz(str(d / 'ckpt-1'), str(d / 'w.npz'), 'cvpr/hi')
    ae.eval()
    ae_p, pc_p = ref.load_npz(str(d / 'w.npz'), 'cpu')
    return ae, pc, pc_config, ae_p, pc_p


def _images(seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, SHAPE + (3,)).astype(np.float32))


def test_ae_c64_matches_reference(wide):
    ae, _, _, ae_p, _ = wide
    x = _images(0)
    with torch.no_grad(), ref.tf32(False):
        enc = ae.encode(x)
        z_ref, syms_ref = ref.ae_encode(ae_p, x, 5)
        assert tuple(enc.symbols.shape) == (2, 4, 6, 64)
        z = enc.z.permute(0, 3, 1, 2)
        assert torch.allclose(z, z_ref, rtol=1e-5, atol=1e-5), (z - z_ref).abs().max()
        syms = enc.symbols.permute(0, 3, 1, 2).long()
        assert (syms != syms_ref).float().mean().item() <= 1e-3
        centers = ae_p['encoder.centers']
        y = ae.decode(centers[syms_ref].permute(0, 2, 3, 1))
        y_ref = ref.ae_decode(ae_p, centers[syms_ref], 5)
    assert y.shape == y_ref.shape == SHAPE + (3,)
    assert (y - y_ref).abs().max().item() <= 0.01


def test_context_model_kf64_matches_reference(wide):
    _, pc, _, ae_p, pc_p = wide
    centers = ae_p['encoder.centers']
    syms = torch.from_numpy(np.random.RandomState(1).randint(0, 6, (2, 64, 4, 6)))
    pad = float(centers[0])
    with torch.no_grad(), ref.tf32(False):
        logits = pc.logits(centers[syms].permute(0, 2, 3, 1), pad)   # (N, C, H, W, L)
        logits_ref = ref.cm_logits(pc_p, centers[syms], pad, 3)      # (N, L, C, H, W)
    assert torch.allclose(logits.permute(0, 4, 1, 2, 3), logits_ref, rtol=1e-5, atol=1e-5)


def test_codec_roundtrip_c64_kf64_plain(wide):
    """encode_batch / decode_batch on the CPU (kernel 2's and 3's plain
    versions): the symbols come back, and the theoretical bits are the
    reference's 16-bit CDF bits of the same symbols."""
    ae, pc, pc_config, ae_p, pc_p = wide
    with torch.no_grad():
        syms = ae.encode(_images(2)).symbols.permute(0, 3, 1, 2).contiguous()
    centers = ae_p['encoder.centers']
    lc = codec_lib.LatentCodec(pc, pc_config, device='cpu')
    res = lc.encode_batch(syms, centers.numpy())
    dec = lc.decode_batch([r.bitstream for r in res], centers.numpy())
    assert torch.equal(torch.as_tensor(dec).long(), syms.long())
    with ref.tf32(False):
        bits = ref.stream_entropy_bits(pc_p, centers, syms, 3, float(centers[0]))
    theo = torch.tensor([r.theoretical_bits for r in res], dtype=torch.float64)
    assert ((theo / bits - 1).abs() <= 2e-6).all(), (theo, bits)
