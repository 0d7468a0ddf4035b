"""Data parallelism over ranks, one device each (port of
imgcomp_cvpr_tpu/parallel/mesh.py).

A training run over N devices is N processes (ranks) in one
``torch.distributed`` process group: NCCL between cards, gloo on the CPU
(or, asked for, between ranks that share a card). Every rank holds the
whole model; the global batch is padded to a multiple of N by repeating its
last element, and each rank takes its slice.

Under ``jax.jit`` with a sharded batch, every mean the JAX loss takes is a
mean over the global batch. The port keeps that: inside ``global_batch(mesh)``,
``batch_mean`` / ``batch_sum`` all-reduce the local sums (a differentiable
all-reduce) and divide by the global count, so every rank computes the
same, global loss. Its backward all-reduces the gradients that flow into the
sums, so each rank's data gradient is N times its share, and
``all_reduce_grads`` (the average over ranks) gives the gradient of the
global loss, with the regularizers, which every rank computes alike,
counted once. Outside the context the means are the local ``mean()``.

Evaluation needs no process group: ``eval.validate.EvalModel`` and
``coding.codec.LatentCodec`` split a batch over a list of devices in one
process.
"""

from __future__ import annotations

import contextlib
import pickle
import socket
from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group."""
    rank: int
    world_size: int
    device: torch.device


def free_port() -> int:
    """A free TCP port on localhost, for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def device_list(device, n: int) -> List[str]:
    """n devices for n ranks or replicas: cuda:0..n-1 (raises when the
    machine has fewer cards), or n times the CPU."""
    from .. import resolve_device
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f'num_devices must be >= 1, got {n}')
    if dev.type == 'cpu':
        return ['cpu'] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f'num_devices {n} exceeds the {have} CUDA card(s) of this machine')
    return [f'cuda:{i}' for i in range(n)]


def init_process_group(rank: int, world_size: int, device, init_method: str,
                       backend: Optional[str] = None) -> Mesh:
    """Join the group of ``world_size`` ranks at ``init_method``
    ('tcp://localhost:<port>') as ``rank``, on ``device``. The backend is
    NCCL for a card, gloo for the CPU, unless ``backend`` names one (gloo
    runs on CUDA tensors too, as ranks that share one card need)."""
    from .. import resolve_device
    dev = resolve_device(device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', dev.index if dev.index is not None else 0)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return Mesh(rank, world_size, dev)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=()):
    """Run fn(rank, *args) in ``nprocs`` fresh processes (start method
    'spawn', so each initialises its own CUDA context) and return rank 0's
    result. An exception in any rank ends the others and is raised here.
    ``fn`` and ``args`` must pickle (a module-level function)."""
    import queue
    import torch.multiprocessing as mp
    out = mp.get_context('spawn').Queue()
    procs = mp.start_processes(_spawned, args=(fn, out, args), nprocs=nprocs,
                               start_method='spawn', join=False)
    result = None
    while result is None:     # read while the ranks run: a full pipe blocks rank 0
        try:
            result = out.get(timeout=1.0)
        except queue.Empty:
            if procs.join(timeout=0):       # raises for a rank that failed
                raise RuntimeError('rank 0 ended without a result')
    while not procs.join():
        pass
    return pickle.loads(result)


def _spawned(rank, fn, out, args):
    result = fn(rank, *args)
    if rank == 0:   # by value: shared-memory tensors die with their process
        out.put(pickle.dumps(result))


def pad_batch_to_multiple(batch: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading dim (repeating the last element) so it divides the mesh."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch
    pad = multiple - rem
    return np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)], axis=0)


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of a global batch whose length divides the world."""
    n = batch.shape[0]
    if n % mesh.world_size:
        raise ValueError(f'a batch of {n} does not split over {mesh.world_size} ranks; '
                         'pad it first (pad_batch_to_multiple)')
    per = n // mesh.world_size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def broadcast_batch(batch: Optional[np.ndarray], shape, mesh: Mesh) -> torch.Tensor:
    """Rank 0's uint8 host batch of ``shape`` (None on the other ranks), as
    a tensor on every rank's device: one broadcast, on the card under NCCL,
    through host memory under gloo."""
    dev = mesh.device if dist.get_backend() == 'nccl' else torch.device('cpu')
    if mesh.rank == 0:
        t = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'batch shape {tuple(t.shape)} != {tuple(shape)}')
    else:
        t = torch.empty(tuple(shape), dtype=torch.uint8, device=dev)
    dist.broadcast(t, src=0)
    return t.to(mesh.device)


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast rank 0's values of ``tensors`` (parameters, buffers) to
    every rank, in place."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Average the gradients over the ranks, in place: one all-reduce of
    all of them, flattened."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= mesh.world_size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def global_batch(mesh: Optional[Mesh]):
    """Inside the block, batch_mean / batch_sum reduce over the global batch
    of ``mesh`` (None: the local batch, as outside)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev


def world_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.world_size


def batch_sum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x.sum(dim) over the global batch (all-reduced inside global_batch)."""
    s = x.sum() if dim is None else x.sum(dim)
    return s if _ACTIVE is None else _AllReduceSum.apply(s)


def batch_mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x.mean(dim) over the global batch: inside global_batch the all-reduced
    sum over the global count (every rank holds an equal slice)."""
    if _ACTIVE is None:
        return x.mean() if dim is None else x.mean(dim)
    dims = range(x.dim()) if dim is None else (dim if isinstance(dim, tuple) else (dim,))
    count = int(np.prod([x.shape[d] for d in dims])) * _ACTIVE.world_size
    return batch_sum(x, dim) / count
