"""Checkpointing and restore logic (port of
imgcomp_cvpr_tpu/training/checkpoint.py; ref: saver.py, restore_manager.py).

``torch.save`` of the tree ``TrainState.state_dict()`` gives, {model: {ae,
pc}, opt_state: {optimizer, schedulers}, step}, with the reference's
conventions:

- layout ``<logdir>/ckpts/ckpt-<itr>`` (one file each);
- a ``var_names.json`` manifest in the ckpt dir listing the saved leaves;
- retention: keep the latest ``max_to_keep`` checkpoints plus one every
  ``keep_every_n_hours``;
- restore picks the latest ckpt with iteration <= itr;
- skip patterns on restore (substring match on a leaf's '/'-joined path,
  e.g. 'opt_state', 'step') keep the freshly initialised values.
"""

from __future__ import annotations

import json
import os
import re
from os import path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import logdir as logdir_lib

CKPT_PREFIX = 'ckpt-'
VAR_NAMES_FILE = 'var_names.json'


def flatten(tree: Dict, prefix: str = '') -> Dict[str, Any]:
    """Nested dicts -> {'/'-joined path: leaf}; anything but a dict is a leaf."""
    out = {}
    for k, v in tree.items():
        name = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


class Saver:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 1,
                 keep_every_n_hours: float = 1.0):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.keep_every_n_hours = keep_every_n_hours
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, tree: Dict, itr: int) -> str:
        """Write ``tree`` (nested dicts of tensors and numbers) as ckpt-<itr>."""
        p = path.join(self.ckpt_dir, f'{CKPT_PREFIX}{itr}')
        tmp = p + '.tmp'
        torch.save(tree, tmp)
        os.replace(tmp, p)
        if not path.exists(path.join(self.ckpt_dir, VAR_NAMES_FILE)):
            write_manifest(self.ckpt_dir, tree)
        self._apply_retention()
        return p

    def _apply_retention(self) -> None:
        ckpts = all_ckpts_with_iterations(self.ckpt_dir)
        if len(ckpts) <= self.max_to_keep:
            return
        protect = {itr for itr, _ in ckpts[-self.max_to_keep:]}
        keep_s = self.keep_every_n_hours * 3600.0
        last_kept_time: Optional[float] = None
        for itr, p in ckpts:
            mtime = os.path.getmtime(p)
            if last_kept_time is None or mtime - last_kept_time >= keep_s:
                protect.add(itr)
                last_kept_time = mtime
        for itr, p in ckpts:
            if itr not in protect:
                os.remove(p)

    def restore(self, itr: Optional[int] = None) -> Tuple[Dict, int]:
        """(tree on the CPU, iteration) of the latest checkpoint, or of the
        latest with iteration <= itr."""
        ckpts = all_ckpts_with_iterations(self.ckpt_dir)
        if not ckpts:
            raise FileNotFoundError(f'No checkpoints in {self.ckpt_dir}')
        if itr is not None and itr != -1:
            ckpts = [(i, p) for i, p in ckpts if i <= itr]
            if not ckpts:
                raise FileNotFoundError(f'No ckpt with itr <= {itr} in {self.ckpt_dir}')
        itr_found, p = ckpts[-1]
        return restore_tree(p), itr_found


def all_ckpts_with_iterations(ckpt_dir: str) -> List[Tuple[int, str]]:
    """Sorted (iteration, path) for every checkpoint in ckpt_dir."""
    out = []
    if not path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(re.escape(CKPT_PREFIX) + r'(\d+)', name)
        if m:
            out.append((int(m.group(1)), path.join(ckpt_dir, name)))
    return sorted(out)


def iteration_of_checkpoint(ckpt_path: str) -> int:
    """The iteration in a checkpoint's file name (``.../ckpt-<itr>``)."""
    m = re.search(re.escape(CKPT_PREFIX) + r'(\d+)', path.basename(ckpt_path))
    if not m:
        raise ValueError(f'not a checkpoint path: {ckpt_path}')
    return int(m.group(1))


def restore_tree(ckpt_path: str) -> Dict:
    """The whole tree of one checkpoint file, on the CPU."""
    return torch.load(ckpt_path, map_location='cpu', weights_only=True)


def write_manifest(ckpt_dir: str, tree: Dict) -> None:
    """(Re)write the ckpt dir's var_names.json for ``tree``'s leaves."""
    with open(path.join(ckpt_dir, VAR_NAMES_FILE), 'w') as f:
        json.dump(sorted(flatten(tree)), f, indent=1)


def merge_with_skip(init_tree: Dict, restored_tree: Dict,
                    skip_patterns: Sequence[str], prefix: str = '') -> Dict:
    """The restored tree laid over ``init_tree``: a leaf comes from the
    checkpoint unless its path matches a skip pattern (substring match, like
    the reference's --restore_skip_vars) or the checkpoint lacks it; then
    the freshly initialised value stays. Leaves only the checkpoint has
    (optimizer moments of a state that has not stepped yet) are taken too."""
    out = {}
    for k in list(init_tree) + [k for k in restored_tree if k not in init_tree]:
        name = f'{prefix}/{k}' if prefix else str(k)
        init_val, restored = init_tree.get(k), restored_tree.get(k)
        if isinstance(init_val, dict) or isinstance(restored, dict):
            if not isinstance(init_val or {}, dict) or not isinstance(restored or {}, dict):
                raise ValueError(f'{name}: checkpoint and model disagree on its kind')
            sub = merge_with_skip(init_val or {}, restored or {}, skip_patterns, name)
            if sub or init_val is not None:     # no empty shells of skipped subtrees
                out[k] = sub
        elif restored is None or any(pat and pat in name for pat in skip_patterns):
            if init_val is not None:
                out[k] = init_val
        else:
            if (isinstance(init_val, torch.Tensor)
                    and tuple(restored.shape) != tuple(init_val.shape)):
                raise ValueError(f'{name}: checkpoint has {tuple(restored.shape)}, '
                                 f'the model {tuple(init_val.shape)}')
            out[k] = restored
    return out


class RestoreManager:
    """--restore / --restore_itr / --restore_continue / --from_identity
    semantics (ref: restore_manager.py:4-37)."""

    def __init__(self, ckpt_dir: str, itr: Optional[int] = None,
                 continue_in_ckpt_dir: bool = False,
                 skip_vars: Sequence[str] = ()):
        self.ckpt_dir = ckpt_dir
        self.itr = itr
        self.continue_in_ckpt_dir = continue_in_ckpt_dir
        self.skip_vars = list(skip_vars)

    @property
    def log_dir(self) -> str:
        return logdir_lib.log_dir_from_ckpt_dir(self.ckpt_dir)

    @classmethod
    def from_flags(cls, flags) -> Optional['RestoreManager']:
        if getattr(flags, 'from_identity', None):
            # restore weights but re-init step and optimizer state
            return cls(flags.from_identity, itr=None, continue_in_ckpt_dir=False,
                       skip_vars=['opt_state', 'step'])
        if not getattr(flags, 'restore', None):
            return None
        skip = []
        if getattr(flags, 'restore_skip_vars', None):
            skip = [s.strip() for s in flags.restore_skip_vars.split(',')]
        itr = getattr(flags, 'restore_itr', -1)
        return cls(flags.restore, itr=None if itr == -1 else itr,
                   continue_in_ckpt_dir=bool(getattr(flags, 'restore_continue', False)),
                   skip_vars=skip)

    def restore(self, state) -> Tuple[Any, int]:
        """Load the checkpoint into ``state`` (a TrainState) in place;
        returns (state, iteration to continue at)."""
        restored, itr = Saver(self.ckpt_dir).restore(self.itr)
        state.load_state_dict(merge_with_skip(state.state_dict(), restored,
                                              self.skip_vars))
        if any('step' in p for p in self.skip_vars):
            itr = 0
        return state, itr
