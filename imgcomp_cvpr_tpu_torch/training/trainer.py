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

On a card without a mesh the step is one CUDA graph, so the host launches
one graph a step instead of thousands of kernels. The first call for a
(state, optimizer state, batch shape, batch dtype) runs eagerly on the
trainer's capture stream, with the optimizer in Adam's capturable form
(optimizers.py): Adam's state, cuDNN's plans and kernel 7's scratch come
into being there. The second captures the whole step (the cast of the
batch, forward, backward, the three updates) and replays it; every later
call copies the batch into the graph's input buffer and replays, inside
the span ``train.graph``. Then the host steps the schedules (each rate a
device tensor, filled in place) and counts a new version of every
parameter and buffer the graph wrote, as an eager update would (the eval
towers' folded operands are keyed on it). comps come out as copies of the
graph's outputs. One graph is kept: another key, ``load_state_dict`` of
the optimizer (its ``version``) or another state warms up and captures
anew. ``LAUNCHES['train_graph_capture']`` and ``['train_graph_replay']``
count the captures and the replays (ops/kernels/build.py); the launches
that the wrappers of kernels 1 and 7 count while the step is captured are
taken back then and added at each replay, so ``LAUNCHES`` counts the
kernels the card runs. The graph runs
the eager step's kernels in its order, so it gives the bits of the eager
step with the same (capturable) optimizer, where cuDNN's algorithms are
deterministic. On the CPU, with a mesh, or with a non-Adam group, the step
is eager, with the optimizer in its host form.

With a ``mesh`` (parallel/mesh.py) the trainer is one rank of a
data-parallel group: a step takes this rank's slice of the global batch,
every batch mean of the loss (BatchNorm statistics, the rate terms,
MS-SSIM's per-scale means, MSE / PSNR, bpp) is a mean over the global batch,
and the gradients are averaged over the ranks before the update, so the
step is the one-device step on the global batch. Modules start from rank
0's values.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import autoencoder as ae_lib
from ..models import probclass as pc_lib
from ..ops import bits as bits_lib
from ..ops import msssim as msssim_lib
from ..ops.kernels import build
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
        self._graph: Optional[_StepGraph] = None   # the captured step
        self._warm: Optional[tuple] = None         # (key, state, optimizer) warmed up last
        self._stream = None                        # the capture stream

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
        device (no host sync here). On a card without a mesh, a CUDA graph
        replay from the second call on (module docstring)."""
        if self._graphs_on(state):
            return self._graphed_step(state, batch)
        return self._eager_step(state, batch)

    def _eager_step(self, state: TrainState, batch
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
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

    # ------------------------------------------------------------------
    # The step as a CUDA graph

    def _graphs_on(self, state: TrainState) -> bool:
        return (self.mesh is None and self.device.type == 'cuda'
                and state.optimizer.graphable)

    def _graphed_step(self, state: TrainState, batch
                      ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        opt = state.optimizer
        key = (id(state), id(opt), opt.version, tuple(batch.shape), batch.dtype)
        if self._warm is None or self._warm[0] != key:
            self._graph = None      # its memory goes before another's comes
            self._warm = (key, state, opt)      # the refs keep the key's ids from reuse
            opt.make_capturable()
            with self._capture_stream():
                return self._eager_step(state, batch)
        g = self._graph
        if g is None:
            x = torch.empty(batch.shape, dtype=batch.dtype, device=self.device)
            opt.zero_grad()     # the graph's backward makes the gradients in its pool
            before = dict(build.LAUNCHES)
            with self._capture_stream():
                graph, names, comps = self._capture(state, x)
            # the wrappers counted launches that the capture only recorded:
            # they are counted at each replay instead
            launches = {k: n - before.get(k, 0) for k, n in build.LAUNCHES.items()
                        if n != before.get(k, 0)}
            for k, n in launches.items():
                build.LAUNCHES[k] -= n
            g = self._graph = _StepGraph(x, graph, names, comps, [
                *state.ae.parameters(), *state.ae.buffers(),
                *state.pc.parameters(), *state.pc.buffers()], launches)
            build.LAUNCHES['train_graph_capture'] += 1
        with span('train.graph'):
            g.batch.copy_(batch, non_blocking=True)
            g.graph.replay()
            comps = g.comps.clone()
        build.LAUNCHES['train_graph_replay'] += 1
        for k, n in g.launches.items():
            build.LAUNCHES[k] += n
        opt.schedule()
        torch.autograd.graph.increment_version(g.written)
        state.step += 1
        return state, dict(zip(g.names, comps.unbind()))

    @contextlib.contextmanager
    def _capture_stream(self):
        """The trainer's side stream for the warm-up step and the capture,
        ordered after and before the caller's stream."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            yield
        caller.wait_stream(self._stream)

    def _graph_body(self, state: TrainState, x: torch.Tensor
                    ) -> Tuple[List[str], torch.Tensor]:
        """What the graph holds: the step's work on the input buffer ``x``;
        comps stacked in one tensor, in the order of the names."""
        total, comps = self.loss_fn(state, x)
        total.backward()
        state.optimizer.update()
        names = list(comps)
        return names, torch.stack([comps[k].detach() for k in names])

    def _capture(self, state: TrainState, x: torch.Tensor):
        """(graph, comps names, comps tensor) of the step captured on the
        current stream; nothing runs until a replay."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.current_stream(self.device),
                              capture_error_mode='thread_local'):
            names, comps = self._graph_body(state, x)
        return graph, names, comps

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


@dataclass
class _StepGraph:
    """The captured training step of the trainer's warmed-up key, and what
    it reads and writes outside its kernels' own pool."""
    batch: torch.Tensor             # the input buffer, copied into before a replay
    graph: object                   # torch.cuda.CUDAGraph
    names: List[str]                # comps, in the order of ``comps``
    comps: torch.Tensor             # (len(names),) float32, overwritten by each replay
    written: List[torch.Tensor]     # parameters and buffers the updates write
    launches: Dict[str, int]        # build.LAUNCHES a replay adds (the wrappers' in the capture)
