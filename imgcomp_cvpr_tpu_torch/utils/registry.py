"""Local run registry (own copy of imgcomp_cvpr_tpu/utils/registry.py).

Replaces the reference's Google-Sheets run log (ref: sheets_logger.py:80-103,
train.py:444-455) with an append-only JSONL file under the log root: the same
record contents (log date, job id, configs, description, git ref), no
network. Appends are serialized with the lock that guards log-dir creation.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, List, Optional

from . import logdir as logdir_lib

REGISTRY_FILE = 'runs.jsonl'


def get_git_ref() -> str:
    """The first 16 hex digits of HEAD, or '' outside a git checkout."""
    try:
        out = subprocess.check_output(['git', 'rev-parse', 'HEAD'],
                                      stderr=subprocess.DEVNULL, timeout=10)
        return out.decode().strip()[:16]
    except (OSError, subprocess.SubprocessError):
        return ''


def insert_run(log_dir_root: str, log_date: str, ae_config_rel_path: str,
               pc_config_rel_path: str, description: str = '',
               is_continue: bool = False,
               job_id: Optional[str] = None) -> None:
    os.makedirs(log_dir_root, exist_ok=True)
    record = {
        'log_date': log_date + ('c' if is_continue else ''),
        'job_id': job_id or os.environ.get('JOB_ID', 'N/A'),
        'ae_config': ae_config_rel_path,
        'pc_config': pc_config_rel_path,
        'description': description,
        'git_ref': get_git_ref(),
        'log_dir_root': log_dir_root,
        'time': time.time(),
    }
    path = os.path.join(log_dir_root, REGISTRY_FILE)
    with logdir_lib.interprocess_lock(path + '.lock'):
        with open(path, 'a') as f:
            f.write(json.dumps(record) + '\n')


def read_runs(log_dir_root: str) -> List[Dict]:
    path = os.path.join(log_dir_root, REGISTRY_FILE)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
