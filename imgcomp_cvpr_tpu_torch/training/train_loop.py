"""Top-level training loop (port of
imgcomp_cvpr_tpu/training/train_loop.py; ref: train.py:58-269).

Wires configs -> log dir -> Trainer -> input pipelines -> the loop with
periodic console/JSONL logging, checkpointing, and test-split evaluation
with the distance-to-BPG monitor (``d_BPG``, NaN where no measured BPG curves
exist) and input / output / heatmap PNGs of the test batch under
``<logdir>/imgs``. A run with a ``description`` is recorded in the run
registry (utils/registry.py). PyTorch enqueues a step's kernels without
waiting for the device, so while step i runs the host fetches batch i + 1
and uploads it from pinned memory; the loop reads device values (a sync)
only at the log intervals.

``steps_per_dispatch`` and ``dispatch_timeout_s`` are accepted for the
reference's command line and do nothing: they steer a remote-dispatch
workaround (fused multi-step dispatches and their watchdog) that the card
does not need (ROADMAP.md, Queue 1, "Deliberately not ported").

``num_devices`` N runs data-parallel (parallel/mesh.py): N ranks, one device
each (cuda:0..N-1, or N gloo ranks on the CPU with ``device='cpu'``), one
process each (N = 1 runs in this process). Rank 0 alone runs the input
pipelines: it pads each global batch to a multiple of N by repeating its
last image and broadcasts it, and every rank trains on its slice. Rank 0
alone writes the log dir, logs, checkpoints, image dumps and the d_BPG
monitor; the checkpoints are those of a one-device run.
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data import pipeline as pipeline_lib
from ..eval import codec_distance as cd
from ..parallel import mesh as mesh_lib
from ..utils import config as config_lib
from ..utils import logdir as logdir_lib
from ..utils import logger as logger_lib
from ..utils import registry as registry_lib
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
          dataset_codec_distance: str = 'testset',
          log_dir_root: str = 'logs',
          restore_manager: Optional[checkpoint_lib.RestoreManager] = None,
          flags: TrainFlags = TrainFlags(),
          ckpt_interval_hours: float = 1.0,
          description: str = '',
          seed: int = 1234,
          device='cuda',
          num_devices: Optional[int] = None) -> str:
    """Train and return the run's log dir; with ``num_devices``, over that
    many ranks (see the module docstring)."""
    kwargs = dict(ae_config_spec=ae_config_spec, pc_config_spec=pc_config_spec,
                  dataset_train=dataset_train, dataset_test=dataset_test,
                  dataset_codec_distance=dataset_codec_distance, log_dir_root=log_dir_root,
                  restore_manager=restore_manager, flags=flags,
                  ckpt_interval_hours=ckpt_interval_hours, description=description,
                  seed=seed)
    if num_devices is None:
        return _train(device=device, mesh=None, **kwargs)
    devices = mesh_lib.device_list(device, num_devices)
    init = f'tcp://localhost:{mesh_lib.free_port()}'
    if num_devices == 1:
        return _rank_main(0, 1, devices, init, kwargs)
    return mesh_lib.spawn(_rank_main, num_devices, (num_devices, devices, init, kwargs))


def _rank_main(rank: int, world: int, devices, init: str, kwargs) -> Optional[str]:
    mesh = mesh_lib.init_process_group(rank, world, devices[rank], init)
    try:
        return _train(device=mesh.device, mesh=mesh, **kwargs)
    finally:
        mesh_lib.destroy_process_group()


def _train(ae_config_spec, pc_config_spec, dataset_train, dataset_test,
           dataset_codec_distance, log_dir_root, restore_manager, flags,
           ckpt_interval_hours, description, seed, device, mesh) -> Optional[str]:
    dev = resolve_device(device)
    lead = mesh is None or mesh.rank == 0     # writes logs, checkpoints, images
    ae_config, ae_rel = config_lib.parse_spec(ae_config_spec, 'ae')
    pc_config, pc_rel = config_lib.parse_spec(pc_config_spec, 'pc')
    log_dir = None
    if lead:
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
            registry_lib.insert_run(
                log_dir_root, logdir_lib.log_date_from_log_dir(log_dir),
                ae_rel, pc_rel, description,
                is_continue=bool(restore_manager and restore_manager.continue_in_ckpt_dir))

    ds_train = pipeline_lib.get_dataset(dataset_train)
    ds_test = pipeline_lib.get_dataset(dataset_test)
    ip_train = pipeline_lib.InputPipeline(
        ds_train, ae_config.crop_size, batch_size=ae_config.batch_size, shuffle=True)
    ip_test = pipeline_lib.InputPipeline(
        ds_test, ae_config.crop_size, batch_size=ae_config.batch_size,
        shuffle=False, num_crops_per_img=1)

    trainer = Trainer(ae_config, pc_config, num_train_images=ds_train.num_images,
                      num_crops_per_img=ip_train.num_crops_per_img, device=dev, mesh=mesh)
    state = trainer.init_state(seed)
    start_itr = 0
    if restore_manager is not None:
        state, start_itr = restore_manager.restore(state)
        if lead:
            print(f'Restored at iteration {start_itr}')

    if lead:
        saver = checkpoint_lib.Saver(logdir_lib.ckpt_dir_for_log_dir(log_dir),
                                     max_to_keep=1,
                                     keep_every_n_hours=ckpt_interval_hours)
        train_logger = logger_lib.MetricsLogger(log_dir, 'train')
        test_logger = logger_lib.MetricsLogger(log_dir, 'test')
        timer = logger_lib.Timer(flags.log_interval_train, ae_config.batch_size)

        # Distance-to-BPG monitor on the test split (ref: train.py:133-143);
        # NaN when no measured codec curves are available.
        try:
            codec_dist = cd.CodecDistance(dataset_codec_distance, 'bpg', 'ms-ssim')
        except cd.CodecDistanceReadException as e:
            print(f'Cannot compute CodecDistance: {e}')
            codec_dist = None

    def d_bpg(bpp: float, ms_ssim: float) -> float:
        if codec_dist is None:
            return float('nan')
        try:
            return codec_dist.distance(bpp, ms_ssim)
        except ValueError:      # bpp outside the codec's curve
            return float('nan')

    def upload(batch: np.ndarray) -> torch.Tensor:
        """uint8 host batch -> device; from pinned memory on a card, so the
        copy overlaps the step that is running."""
        t = torch.from_numpy(batch)
        if dev.type == 'cuda':
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def fetch(ip) -> Optional[np.ndarray]:
        """The next global batch: rank 0 reads the pipeline (the others
        receive it in put)."""
        return ip.get_batch() if lead else None

    def put(batch: Optional[np.ndarray]) -> torch.Tensor:
        """Global batch -> this rank's slice on the device."""
        if mesh is None:
            return upload(batch)
        n = -(-ae_config.batch_size // mesh.world_size) * mesh.world_size
        shape = (n,) + tuple(ae_config.crop_size) + (3,)
        return mesh_lib.shard_batch(mesh_lib.broadcast_batch(
            None if batch is None else mesh_lib.pad_batch_to_multiple(batch, mesh.world_size),
            shape, mesh), mesh)

    profiler = None
    itr = start_itr
    if lead:
        ip_train.start()
        ip_test.start()
    try:
        pending = None
        while flags.max_steps is None or itr < flags.max_steps:
            if flags.profile_steps and itr == 10 and lead:
                profiler = _start_profiler(dev)
            dev_batch = pending if pending is not None else put(fetch(ip_train))
            state, comps = trainer.train_step(state, dev_batch)
            itr += 1
            pending = None
            if flags.max_steps is None or itr < flags.max_steps:
                pending = put(fetch(ip_train))   # overlaps the step above
            if lead:
                timer.add(ae_config.batch_size)
            if profiler is not None and itr == 10 + flags.profile_steps:
                _stop_profiler(profiler, os.path.join(log_dir, 'profile'))
                profiler = None

            if itr % flags.log_interval_train == 0 and lead:
                scalars = {k: float(v) for k, v in comps.items()}   # syncs
                scalars['img_per_sec'] = timer.get_avg_ex_per_sec()
                train_logger.log(itr, scalars)
                timer.reset()

            if itr % flags.log_interval_save == 0 and lead:
                saver.save(state.state_dict(), itr)

            if flags.log_interval_test > 0 and itr % flags.log_interval_test == 0:
                test_batch_np = fetch(ip_test)
                test_batch = put(test_batch_np)
                out = trainer.eval_step(state, test_batch)
                if lead:
                    scalars = {k: float(v) for k, v in out.items()}
                    _dump_test_images(log_dir, itr, state,
                                      test_batch if mesh is None else upload(test_batch_np),
                                      test_batch_np)
                    scalars['d_BPG'] = d_bpg(scalars['bpp'], scalars['ms_ssim_eval'])
                    test_logger.log(itr, scalars)
    finally:
        if lead:
            ip_train.stop()
            ip_test.stop()
            if profiler is not None:
                _stop_profiler(profiler, os.path.join(log_dir, 'profile'))
            saver.save(state.state_dict(), max(itr, 1))
            train_logger.close()
            test_logger.close()
    return log_dir


def _dump_test_images(log_dir: str, itr: int, state, test_batch: torch.Tensor,
                      test_batch_np: np.ndarray, n: int = 3) -> None:
    """Input, output and heatmap PNGs of the first ``n`` test images, the
    model in eval mode (the reference's image summaries, ref
    train.py:163-171), as <logdir>/imgs/<itr>_<i>_{in,out,hm}.png. A failure
    is reported and never ends the run."""
    try:
        from PIL import Image
        with torch.no_grad():
            enc = state.ae.encode(test_batch[:n].to(torch.float32))
            x_out = state.ae.decode(enc.qhard)
        out_dir = os.path.join(log_dir, 'imgs')
        os.makedirs(out_dir, exist_ok=True)
        x_out_np = x_out.cpu().numpy().astype(np.uint8)
        hm_np = None
        if enc.heatmap is not None:
            hm_np = enc.heatmap.sum(-1).cpu().numpy()
            hm_np = (hm_np / max(hm_np.max(), 1e-6) * 255).astype(np.uint8)
        for i in range(x_out_np.shape[0]):
            prefix = os.path.join(out_dir, f'{itr:08d}_{i}')
            Image.fromarray(test_batch_np[i].astype(np.uint8)).save(prefix + '_in.png')
            Image.fromarray(x_out_np[i]).save(prefix + '_out.png')
            if hm_np is not None:
                Image.fromarray(hm_np[i]).save(prefix + '_hm.png')
    except Exception:   # a summary must not end training
        print('image dump failed:')
        traceback.print_exc()


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
