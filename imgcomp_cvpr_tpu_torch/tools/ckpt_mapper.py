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
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional

import torch

from ..training import checkpoint as checkpoint_lib


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
    flags = p.parse_args(argv)
    if flags.cmd == 'show':
        print_all_in_ckpt(flags.ckpt_path)
    else:
        def map_name(name: str):
            for old, new in flags.sub:
                name = name.replace(old, new)
            return name
        create_new_ckpt_with_name_mapping(flags.ckpt_path, flags.out_ckpt_dir,
                                          flags.itr, map_name)


if __name__ == '__main__':
    main()
