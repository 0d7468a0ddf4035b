"""Metrics logging: console + JSONL event log (+ TensorBoard if available).
Own copy of imgcomp_cvpr_tpu/utils/logger.py (the port imports nothing of
that package).

Replaces the reference's Logger/summary machinery (ref: logger.py:5-63,
train.py:147-179): scalars are collected per step and emitted in one line,
and every event is appended to ``events.jsonl`` in the log dir so external
tooling can plot without TF. If ``tensorboardX``/``torch.utils.tensorboard``
is importable, scalars are mirrored there too.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = 'train'):
        self.log_dir = log_dir
        self.name = name
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f'events_{name}.jsonl'), 'a')
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(os.path.join(log_dir, 'tb', name))
        except Exception:
            pass

    def log(self, step: int, scalars: Dict[str, float],
            append: Optional[str] = None, to_console: bool = True) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        record = {'step': step, 'time': time.time(), **scalars}
        self._jsonl.write(json.dumps(record) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f'{self.name}/{k}', v, step)
        if to_console:
            body = ' '.join(f'{k}={v:.4g}' for k, v in scalars.items())
            extra = f' {append}' if append else ''
            print(f'[{self.name} {step:>8d}] {body}{extra}', flush=True)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Timer:
    """img/s timer (ref: train.py:201-213). Counts the examples actually
    processed instead of assuming the interval was fully consumed."""

    def __init__(self, log_interval: int, batch_size: int):
        self.log_interval = log_interval
        self.batch_size = batch_size
        self.num_examples = 0
        self.start_time = time.time()

    def add(self, num_examples: int) -> None:
        self.num_examples += num_examples

    def get_avg_ex_per_sec(self) -> float:
        elapsed = max(time.time() - self.start_time, 1e-9)
        if self.num_examples:
            return self.num_examples / elapsed
        # legacy path: callers that never add() get the old estimate
        return self.batch_size * self.log_interval / elapsed

    def reset(self) -> None:
        self.num_examples = 0
        self.start_time = time.time()
