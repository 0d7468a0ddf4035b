"""Top-level training loop (port of
imgcomp_cvpr_tpu/training/train_loop.py; ref: train.py:58-269).

Wires configs -> log dir -> Trainer -> input pipelines -> the loop with
periodic console/JSONL logging, checkpointing, and test-split evaluation.
PyTorch enqueues a step's kernels without waiting for the device, so while
step i runs the host fetches batch i + 1 and uploads it from pinned memory;
the loop reads device values (a sync) only at the log intervals.

Not ported yet (ROADMAP Queue 1 #10): the run registry behind
``description``, the distance-to-BPG monitor, the test-image dumps and the
dispatch watchdog. ``steps_per_dispatch`` and ``dispatch_timeout_s`` are
accepted for the reference's command line and do nothing: they steer a
remote-dispatch workaround the card does not need.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import pipeline as pipeline_lib
from ..utils import config as config_lib
from ..utils import logdir as logdir_lib
from ..utils import logger as logger_lib
from . import checkpoint as checkpoint_lib
from .trainer import Trainer


@dataclass
class TrainFlags:
    log_interval_train: int = 100
    log_interval_test: int = 1000
    log_interval_save: int = 1000
    max_steps: Optional[int] = None
    profile_steps: Optional[int] = None  # trace steps [10, 10+profile_steps)
    steps_per_dispatch: int = 8          # no-op, see the module docstring
    dispatch_timeout_s: float = 900.0    # no-op, see the module docstring


def train(ae_config_spec: str, pc_config_spec: str,
          dataset_train: str = 'synthetic:64',
          dataset_test: str = 'synthetic:8',
          log_dir_root: str = 'logs',
          restore_manager: Optional[checkpoint_lib.RestoreManager] = None,
          flags: TrainFlags = TrainFlags(),
          ckpt_interval_hours: float = 1.0,
          description: str = '',
          seed: int = 1234,
          device='cuda') -> str:
    """Train and return the run's log dir."""
    dev = resolve_device(device)
    ae_config, ae_rel = config_lib.parse_spec(ae_config_spec, 'ae')
    pc_config, pc_rel = config_lib.parse_spec(pc_config_spec, 'pc')
    print(f'Using ae_config ({ae_rel}):\n{ae_config}\n---\n'
          f'Using pc_config ({pc_rel}):\n{pc_config}')

    if restore_manager is not None and restore_manager.continue_in_ckpt_dir:
        log_dir = restore_manager.log_dir
    else:
        log_dir = logdir_lib.create_unique_log_dir(
            [ae_rel, pc_rel], log_dir_root,
            restore_dir=restore_manager.ckpt_dir if restore_manager else None)
    print(f'- LOG DIR: {log_dir}')
    if description:
        print('(description not recorded: the run registry is not ported)')

    ds_train = pipeline_lib.get_dataset(dataset_train)
    ds_test = pipeline_lib.get_dataset(dataset_test)
    ip_train = pipeline_lib.InputPipeline(
        ds_train, ae_config.crop_size, batch_size=ae_config.batch_size, shuffle=True)
    ip_test = pipeline_lib.InputPipeline(
        ds_test, ae_config.crop_size, batch_size=ae_config.batch_size,
        shuffle=False, num_crops_per_img=1)

    trainer = Trainer(ae_config, pc_config, num_train_images=ds_train.num_images,
                      num_crops_per_img=ip_train.num_crops_per_img, device=dev)
    state = trainer.init_state(seed)
    start_itr = 0
    if restore_manager is not None:
        state, start_itr = restore_manager.restore(state)
        print(f'Restored at iteration {start_itr}')

    saver = checkpoint_lib.Saver(logdir_lib.ckpt_dir_for_log_dir(log_dir),
                                 max_to_keep=1,
                                 keep_every_n_hours=ckpt_interval_hours)
    train_logger = logger_lib.MetricsLogger(log_dir, 'train')
    test_logger = logger_lib.MetricsLogger(log_dir, 'test')
    timer = logger_lib.Timer(flags.log_interval_train, ae_config.batch_size)

    def put(batch: np.ndarray) -> torch.Tensor:
        """uint8 host batch -> device; from pinned memory on a card, so the
        copy overlaps the step that is running."""
        t = torch.from_numpy(batch)
        if dev.type == 'cuda':
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    profiler = None
    itr = start_itr
    ip_train.start()
    ip_test.start()
    try:
        pending = None
        while flags.max_steps is None or itr < flags.max_steps:
            if flags.profile_steps and itr == 10:
                profiler = _start_profiler(dev)
            dev_batch = pending if pending is not None else put(ip_train.get_batch())
            state, comps = trainer.train_step(state, dev_batch)
            itr += 1
            pending = None
            if flags.max_steps is None or itr < flags.max_steps:
                pending = put(ip_train.get_batch())   # overlaps the step above
            timer.add(ae_config.batch_size)
            if profiler is not None and itr == 10 + flags.profile_steps:
                _stop_profiler(profiler, os.path.join(log_dir, 'profile'))
                profiler = None

            if itr % flags.log_interval_train == 0:
                scalars = {k: float(v) for k, v in comps.items()}   # syncs
                scalars['img_per_sec'] = timer.get_avg_ex_per_sec()
                train_logger.log(itr, scalars)
                timer.reset()

            if itr % flags.log_interval_save == 0:
                saver.save(state.state_dict(), itr)

            if flags.log_interval_test > 0 and itr % flags.log_interval_test == 0:
                test_out = trainer.eval_step(state, put(ip_test.get_batch()))
                test_logger.log(itr, {k: float(v) for k, v in test_out.items()})
    finally:
        ip_train.stop()
        ip_test.stop()
        if profiler is not None:
            _stop_profiler(profiler, os.path.join(log_dir, 'profile'))
        saver.save(state.state_dict(), max(itr, 1))
        train_logger.close()
        test_logger.close()
    return log_dir


def _start_profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, out_dir: str) -> None:
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, 'trace.json'))
