"""Checkpoint GC: for every run in a log root, move all but the {second,
middle, last} checkpoints to an archive dir (port of
imgcomp_cvpr_tpu/tools/purge_checkpoints.py; ref: purge_checkpoints.py:11-31).

    python -m imgcomp_cvpr_tpu_torch.tools.purge_checkpoints LOG_ROOT ARCHIVE_DIR -v
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
from os import path

from ..training import checkpoint as checkpoint_lib
from ..utils import logdir as logdir_lib


def purge_checkpoints(log_dir_root: str, target_dir: str, verbose: bool = False) -> None:
    vprint = print if verbose else (lambda *a, **k: None)
    ckpt_dir_glob = logdir_lib.ckpt_dir_for_log_dir(path.join(log_dir_root, '*'))
    for ckpt_dir in sorted(glob.glob(ckpt_dir_glob)):
        log_dir = logdir_lib.log_dir_from_ckpt_dir(ckpt_dir)
        all_ckpts = checkpoint_lib.all_ckpts_with_iterations(ckpt_dir)
        if len(all_ckpts) <= 5:
            vprint(f'Skipping {log_dir} ({len(all_ckpts)} ckpts)')
            continue
        keep = {all_ckpts[1][0], all_ckpts[len(all_ckpts) // 2][0], all_ckpts[-1][0]}
        vprint(f'{log_dir}: keeping iterations {sorted(keep)}')
        for itr, p in all_ckpts:
            if itr in keep:
                continue
            target = path.join(target_dir, path.basename(log_dir),
                               checkpoint_lib.CKPT_PREFIX + str(itr))
            os.makedirs(path.dirname(target), exist_ok=True)
            vprint(f'  {p} -> {target}')
            shutil.move(p, target)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('log_dir_root')
    p.add_argument('target_dir')
    p.add_argument('--verbose', '-v', action='store_true')
    flags = p.parse_args(argv)
    purge_checkpoints(flags.log_dir_root, flags.target_dir, flags.verbose)


if __name__ == '__main__':
    main()
