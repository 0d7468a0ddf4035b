"""Trainer: model construction, train/eval steps, state init (port of
imgcomp_cvpr_tpu/training/trainer.py; ref: train.py:86-127).

The state is a ``TrainState`` of modules and optimizer, updated in place by
``train_step`` (the JAX package returns a new pytree; here the returned
state is the one passed in). A train step is forward (AE in train mode ->
kernel 1 -> decoder on qbar; context model on the detached qbar) ->
loss -> backward (kernel 7 under QuantizeFn) -> the three optimizer
groups. While a profiler records, the phases are spans (utils/spans.py):
``train.forward``, ``train.backward``, ``train.all_reduce`` with a mesh,
``train.optimizer``. The reference's multi-step dispatch (``_train_multi``,
a scan that hides its remote-dispatch latency) has no counterpart: PyTorch
enqueues each step's kernels without waiting for the device.

With a ``mesh`` (parallel/mesh.py) the trainer is one rank of a
data-parallel group: a step takes this rank's slice of the global batch,
every batch mean of the loss (BatchNorm statistics, the rate terms,
MS-SSIM's per-scale means, MSE / PSNR, bpp) is a mean over the global batch,
and the gradients are averaged over the ranks before the update, so the
step is the one-device step on the global batch. Modules start from rank
0's values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import autoencoder as ae_lib
from ..models import probclass as pc_lib
from ..ops import bits as bits_lib
from ..ops import msssim as msssim_lib
from ..parallel import mesh as mesh_lib
from ..utils.spans import span
from . import distortions as distortions_lib
from . import losses as losses_lib
from . import optimizers as opt_lib


@dataclass
class TrainState:
    ae: ae_lib.CVPRAutoencoder      # parameters and BatchNorm running statistics
    pc: pc_lib.ProbClassifier
    optimizer: opt_lib.GroupedOptimizer
    step: int

    def state_dict(self) -> Dict:
        return {'model': {'ae': self.ae.state_dict(), 'pc': self.pc.state_dict()},
                'opt_state': self.optimizer.state_dict(), 'step': self.step}

    def load_state_dict(self, tree: Dict) -> None:
        self.ae.load_state_dict(tree['model']['ae'], strict=True)
        self.pc.load_state_dict(tree['model']['pc'], strict=True)
        self.optimizer.load_state_dict(tree['opt_state'])
        self.step = int(tree['step'])


class Trainer:
    def __init__(self, ae_config, pc_config, num_train_images: int = 1_281_167,
                 num_crops_per_img: int = 1, device='cuda',
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.ae_config = ae_config
        self.pc_config = pc_config
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.itr_per_epoch = opt_lib.num_itr_per_epoch(
            num_train_images, ae_config.batch_size, num_crops_per_img)

    def init_state(self, seed: int) -> TrainState:
        """Fresh modules on the trainer's device, initialised from ``seed``
        (AE from seed, context model from seed + 1), and their optimizer."""
        ae = ae_lib.get_network_cls(self.ae_config)(self.ae_config, device=self.device)
        pc = pc_lib.ProbClassifier(self.pc_config, self.ae_config.num_centers,
                                   device=self.device)
        ae_lib.init_params(ae, seed)
        pc_lib.init_params(pc, seed + 1)
        if self.mesh is not None:
            mesh_lib.replicate([*ae.parameters(), *ae.buffers(), *pc.parameters(),
                                *pc.buffers()], self.mesh)
        optimizer = opt_lib.make_optimizer(ae, pc, self.ae_config, self.pc_config,
                                           self.itr_per_epoch)
        return TrainState(ae, pc, optimizer, 0)

    # ------------------------------------------------------------------

    def _to_device(self, batch) -> torch.Tensor:
        """uint8 (or float) NHWC batch, numpy or tensor -> float32 on the
        device; the cast happens there."""
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        return batch.to(self.device, non_blocking=True).to(torch.float32)

    def _bitcost(self, state: TrainState, q: torch.Tensor, symbols: torch.Tensor):
        pad_value = pc_lib.auto_pad_value(self.pc_config, state.ae.encoder.centers,
                                          state.pc)
        return state.pc.bitcost(q, symbols, pad_value)

    def loss_fn(self, state: TrainState, batch
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Training forward: (total_loss, comps), differentiable; moves the
        BatchNorm running statistics."""
        x = self._to_device(batch)
        with mesh_lib.global_batch(self.mesh):
            return self._loss(state, x)

    def _loss(self, state: TrainState, x: torch.Tensor):
        enc, x_out = state.ae(x, True)
        # The context model sees qbar with the gradient stopped
        # (ref: train.py:104-105).
        bc = self._bitcost(state, enc.qbar.detach(), enc.symbols)
        d_loss, d_comps = distortions_lib.compute(self.ae_config, x, x_out,
                                                  is_training=True)
        total, comps = losses_lib.total_loss(
            self.ae_config, self.pc_config, d_loss, bc, enc.heatmap,
            state.ae, state.pc, state.ae.encoder.centers)
        comps.update(d_comps)
        comps['bpp'] = bits_lib.bitcost_to_bpp(bc, x)
        return total, comps

    def train_step(self, state: TrainState, batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update of ``state`` in place. comps are 0-d tensors on the
        device (no host sync here)."""
        state.optimizer.zero_grad()
        with span('train.forward'):
            total, comps = self.loss_fn(state, batch)
        with span('train.backward'):
            total.backward()
        if self.mesh is not None:
            with span('train.all_reduce'):
                mesh_lib.all_reduce_grads([*state.ae.parameters(), *state.pc.parameters()],
                                          self.mesh)
        with span('train.optimizer'):
            state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in comps.items()}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Test-mode forward (running statistics, decode(qhard), bitcost of
        qhard; ref: train.py:115-127)."""
        x = self._to_device(batch)
        enc = state.ae.encode(x)
        x_out = state.ae.decode(enc.qhard)
        bc = self._bitcost(state, enc.qhard, enc.symbols)
        with mesh_lib.global_batch(self.mesh):
            _, d_comps = distortions_lib.compute(self.ae_config, x, x_out,
                                                 is_training=False)
            out = dict(d_comps)
            out['bpp'] = bits_lib.bitcost_to_bpp(bc, x)
            out['ms_ssim_eval'] = msssim_lib.msssim_eval(x, x_out)
        return out

