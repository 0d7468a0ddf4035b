"""Offline checkpoint surgery: rename/remap state entries between
checkpoints (port of imgcomp_cvpr_tpu/tools/ckpt_mapper.py; the reference's
save_mapper.py:40-58 migration utility).

Works on the flat form of the port's ``torch.save`` trees: a mapping
function receives each '/'-joined leaf path ('model/ae/encoder.h1.weight',
...) and returns the new path, or None to drop the leaf. A dict with keys
that are not strings (an optimizer's per-parameter state, keyed by int) is
one leaf, so its keys survive the round trip. The new checkpoint's
directory gets a ``var_names.json`` manifest of the new names.

    python -m imgcomp_cvpr_tpu_torch.tools.ckpt_mapper show LOG_DIR/ckpts/ckpt-9000
    python -m imgcomp_cvpr_tpu_torch.tools.ckpt_mapper rename LOG_DIR/ckpts/ckpt-9000 \
        OUT/ckpts --itr 9000 --sub model/pc/net.conv_out model/pc/net.conv2

``npz`` exports a checkpoint's model (not its optimizer state or step) to
the flat flax layout of ``assets/demo_trained_low_9000.npz``:
'params/ae/...', 'params/pc/...' and 'batch_stats/...' leaves, one npz
entry each, which ``weights.load_trained`` and the benchmark's reference
read. ``--ae_config`` names the AE's config, whose transposed convolutions
the layout needs; ``--half`` stores the AE's convolution kernels in
float16 (half the file; every other leaf stays float32):

    python -m imgcomp_cvpr_tpu_torch.tools.ckpt_mapper npz LOG_DIR/ckpts/ckpt-9000 \
        out.npz --ae_config cvpr/hi_demo --half
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import weights as weights_lib
from ..models import autoencoder as ae_lib
from ..training import checkpoint as checkpoint_lib
from ..utils import config as config_lib


def _flatten(tree: Dict, prefix: str = '') -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict) and v and all(isinstance(kk, str) for kk in v):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _describe(value) -> str:
    if isinstance(value, torch.Tensor):
        return f'{tuple(value.shape)}  {value.dtype}'
    if isinstance(value, dict):
        return f'{{{len(value)} entries}}  dict'
    return f'()  {type(value).__name__}'


def print_all_in_ckpt(ckpt_path: str) -> None:
    """(ref: save_mapper.py:10-15)"""
    tree = checkpoint_lib.restore_tree(ckpt_path)
    for name, value in sorted(_flatten(tree).items()):
        print(f'{name}  {_describe(value)}')


def create_new_ckpt_with_name_mapping(
        ckpt_path: str, out_ckpt_dir: str, out_itr: int,
        map_name: Callable[[str], Optional[str]]) -> str:
    """(ref: save_mapper.py:40-58)"""
    flat = _flatten(checkpoint_lib.restore_tree(ckpt_path))
    new_flat = {}
    for name, value in flat.items():
        new_name = map_name(name)
        if new_name is None:
            print(f'drop: {name}')
            continue
        if new_name != name:
            print(f'{name} -> {new_name}')
        new_flat[new_name] = value
    tree = _unflatten(new_flat)
    saver = checkpoint_lib.Saver(out_ckpt_dir, max_to_keep=1000)
    out = saver.save(tree, out_itr)
    # Saver.save writes a manifest only into a directory that has none; a
    # renamed tree must not keep the old names.
    checkpoint_lib.write_manifest(saver.ckpt_dir, tree)
    return out


def export_npz(ckpt_path: str, out_path: str, ae_config_spec: str,
               half: bool = False) -> Dict[str, np.ndarray]:
    """Write the model of checkpoint ``ckpt_path`` to ``out_path`` in the
    flat npz layout (``weights.ae_trees`` / ``pc_tree``: every tensor of
    the AE's and the context model's state dicts, or KeyError); -> the
    leaves written."""
    model = checkpoint_lib.restore_tree(ckpt_path)['model']
    ae_config, _ = config_lib.parse_spec(ae_config_spec, 'ae')
    ae = ae_lib.get_network_cls(ae_config)(ae_config, device='cpu')
    params, stats = weights_lib.ae_trees(model['ae'], ae)
    trees = (('params/ae', params), ('params/pc', weights_lib.pc_tree(model['pc'])),
             ('batch_stats', stats))
    flat = {k: np.ascontiguousarray(v) for prefix, tree in trees
            for k, v in checkpoint_lib.flatten(tree, prefix).items()}
    if half:
        flat = {k: v.astype(np.float16) if k.startswith('params/ae/') and k.endswith('/w')
                else v for k, v in flat.items()}
    with open(out_path, 'wb') as f:
        np.savez(f, **flat)
    return flat


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest='cmd', required=True)
    show = sub.add_parser('show')
    show.add_argument('ckpt_path')
    ren = sub.add_parser('rename')
    ren.add_argument('ckpt_path')
    ren.add_argument('out_ckpt_dir')
    ren.add_argument('--itr', type=int, default=0)
    ren.add_argument('--sub', nargs=2, action='append', default=[],
                     metavar=('OLD', 'NEW'), help='substring replacement')
    npz = sub.add_parser('npz')
    npz.add_argument('ckpt_path')
    npz.add_argument('out_npz')
    npz.add_argument('--ae_config', required=True, help="the AE's config, e.g. 'cvpr/hi_demo'")
    npz.add_argument('--half', action='store_true',
                     help="store the AE's convolution kernels in float16")
    flags = p.parse_args(argv)
    if flags.cmd == 'show':
        print_all_in_ckpt(flags.ckpt_path)
    elif flags.cmd == 'npz':
        flat = export_npz(flags.ckpt_path, flags.out_npz, flags.ae_config, flags.half)
        print(f'{flags.out_npz}: {len(flat)} leaves')
    else:
        def map_name(name: str):
            for old, new in flags.sub:
                name = name.replace(old, new)
            return name
        create_new_ckpt_with_name_mapping(flags.ckpt_path, flags.out_ckpt_dir,
                                          flags.itr, map_name)


if __name__ == '__main__':
    main()
