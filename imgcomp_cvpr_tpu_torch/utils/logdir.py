"""Log-dir naming and config-path recovery. Own copy of
imgcomp_cvpr_tpu/utils/logdir.py (the port imports nothing of that package).

Mirrors the reference's conventions (ref: logdir_helpers.py:34-151):

- A run's log dir is named ``MMDD_HHMM <ae_cfg> <pc_cfg> [RESTORE@...]`` where
  the config components are the configs' paths relative to their config roots
  with ``/`` mangled to ``@`` and ``-`` to ``*``.
- ``config_paths_from_log_dir`` recovers the actual config files by
  glob-matching the de-mangled components against the config roots — config
  identity is part of checkpoint identity.

Concurrency: creation is serialized with an O_EXCL lock file per log root
(the reference used ``fasteners.InterProcessLock``, logdir_helpers.py:86).
"""

from __future__ import annotations

import errno
import glob
import os
import re
import time
from contextlib import contextmanager
from datetime import datetime, timedelta
from os import path
from typing import Iterator, List, Sequence, Tuple

LOG_DATE_FORMAT = '%m%d_%H%M'
_RESTORE_PREFIX = 'RESTORE@'

CKPTS_DIR_NAME = 'ckpts'


@contextmanager
def interprocess_lock(lock_path: str, timeout_s: float = 60.0, poll_s: float = 0.05):
    """Simple cross-process lock via O_CREAT|O_EXCL; stale locks expire after timeout."""
    start = time.time()
    while True:
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            break
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise
            if time.time() - start > timeout_s:
                try:  # break a stale lock
                    os.remove(lock_path)
                except OSError:
                    pass
            time.sleep(poll_s)
    try:
        yield
    finally:
        try:
            os.remove(lock_path)
        except OSError:
            pass


def ckpt_dir_for_log_dir(log_dir: str) -> str:
    return path.join(log_dir, CKPTS_DIR_NAME)


def log_dir_from_ckpt_dir(ckpt_dir: str) -> str:
    assert path.basename(ckpt_dir.rstrip(path.sep)) == CKPTS_DIR_NAME, ckpt_dir
    return path.dirname(ckpt_dir.rstrip(path.sep))


def create_unique_log_dir(config_rel_paths: Sequence[str], log_dir_root: str,
                          line_breaking_chars_pat: str = r'[-]',
                          restore_dir: str = None) -> str:
    if any(':' in p for p in config_rel_paths):
        raise ValueError(f'":" not allowed in paths, got {config_rel_paths}')

    def prep_path(p: str) -> str:
        p = p.replace(path.sep, '@')
        return re.sub(line_breaking_chars_pat, '*', p)

    postfix = ' '.join(prep_path(p) for p in config_rel_paths)
    if restore_dir:
        root, job_component = _split_log_dir(restore_dir)
        postfix += ' {}{}@{}'.format(
            _RESTORE_PREFIX, root.replace(path.sep, '@'),
            log_date_from_log_dir(job_component))

    os.makedirs(log_dir_root, exist_ok=True)
    with interprocess_lock(path.join(log_dir_root, 'lock')):
        return _mkdir_unique(log_dir_root, datetime.now(), postfix)


def _split_log_dir(log_dir: str) -> Tuple[str, str]:
    root_comps: List[str] = []
    for comp in log_dir.split(path.sep):
        if is_log_date(comp.split(' ')[0]):
            return path.sep.join(root_comps), comp
        root_comps.append(comp)
    raise AssertionError(f'Invalid log_dir: {log_dir}')


def _mkdir_unique(log_dir_root: str, log_date: datetime, postfix: str) -> str:
    log_date_str = log_date.strftime(LOG_DATE_FORMAT)
    existing = {d.split(' ')[0] for d in os.listdir(log_dir_root)}
    if log_date_str in existing:
        return _mkdir_unique(log_dir_root, log_date + timedelta(minutes=1), postfix)
    log_dir = path.join(log_dir_root, f'{log_date_str} {postfix}')
    os.makedirs(log_dir)
    return log_dir


def log_date_from_log_dir(log_dir: str) -> str:
    possible = os.path.basename(log_dir).split(' ')[0]
    if not is_log_date(possible):
        raise ValueError(f'Invalid log dir: {log_dir}')
    return possible


def is_log_date(s: str) -> bool:
    try:
        datetime.strptime(s, LOG_DATE_FORMAT)
        return True
    except ValueError:
        return False


def config_paths_from_log_dir(log_dir: str, base_dirs: Sequence[str]) -> Tuple[str, ...]:
    log_dir = path.basename(log_dir.rstrip(path.sep))
    comps = log_dir.split(' ')
    assert is_log_date(comps[0]), f'Invalid log_dir: {log_dir}'
    comps = [c for c in comps[1:] if _RESTORE_PREFIX not in c]
    assert len(comps) <= len(base_dirs), f'{comps} vs {base_dirs}'

    def get_real_path(base: str, prepped: str) -> str:
        p_glob = path.join(base, prepped.replace('@', path.sep))
        # '*' only ever replaced one char, so filter to same-length matches.
        matches = [g for g in glob.glob(p_glob) if len(g) == len(p_glob)]
        if len(matches) != 1:
            raise ValueError(f'Cannot find config on disk: {p_glob} (matches: {matches})')
        return matches[0]

    return tuple(get_real_path(b, c) for b, c in zip(base_dirs, comps))


def iter_ckpt_dirs(log_dir_root: str, job_ids_str: str) -> Iterator[str]:
    """Yield ckpt dirs of runs whose log-date matches any of the comma-separated job ids."""
    assert os.path.exists(log_dir_root), f'Invalid log dir: {log_dir_root}'
    job_ids = job_ids_str.strip().replace(';', ',').split(',')
    for job_id in job_ids:
        pattern = ckpt_dir_for_log_dir(path.join(log_dir_root, job_id + '*'))
        matches = glob.glob(pattern)
        if len(matches) != 1:
            print(f'*** ERR: {len(matches)} matches for {pattern}')
            continue
        yield matches[0]
