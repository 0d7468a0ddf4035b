"""A cell on more than one card: one rank a card, started through the
program's own ``parallel/mesh.py``.

``run_ranks`` (run.py) and ``readings_on_ranks`` (control.py) start N
ranks with ``mesh.spawn``; rank r joins the group with
``mesh.init_process_group`` on ``cuda:r`` (NCCL), or on the CPU under gloo
(the tests), and leaves it with ``mesh.destroy_process_group``. Every rank
runs set-up, the three checked steps and the window; rank 0 alone reads
the clock, decides when the window ends, runs the reference and hands back
the result, which the starting process prints.

The stop decision travels on a host-side store (``Gate``), never on the
card: before each step rank 0 decides whether the step ``Gate.LAG`` steps
on is taken and sets one key to go or stop, and the others read that key
when they get there. So every rank takes the same number of steps, no step
gains a device synchronize, and ranks 1.. may run as far ahead of rank 0's
host as the program's own loop lets them (they block only on a key that
rank 0 has not yet set).

Bounded time: a rank that fails ends the run through ``mesh.spawn``,
which ends the other ranks and raises; the store's gets time out after
``STORE_TIMEOUT_S``; the starting process ends every rank and exits
non-zero once ``seconds + STALL_S`` have passed since the ranks started;
a rank whose starting process is gone ends itself.
"""

from __future__ import annotations

import contextlib
import itertools
import multiprocessing
import os
import sys
import threading
import time
import traceback
from datetime import timedelta
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

STORE_TIMEOUT_S = 120.0
STALL_S = 300.0         # set-up, the reference and the trace's reading, beyond the window
STALLED = 4             # the exit code of a run that the watchdog ended
ORPHANED = 5            # a rank's exit code when its starting process is gone


class Gate:
    """One window's stop decision, step by step, from rank 0 to the others,
    made ``LAG`` steps ahead: the first LAG steps are always taken, and a
    window runs on for LAG steps after rank 0's clock has passed its end
    (they count, with their time)."""

    LAG = 2

    def __init__(self, store, lead: bool, prefix: str):
        self.store, self.lead, self.prefix = store, lead, prefix
        self.ahead = {}         # rank 0: step -> its decision
        self.seconds = 0.0      # host time spent in go()

    def go(self, step: int, decide) -> bool:
        """Whether ``step`` is taken. Rank 0 also decides step + LAG
        (decide(), once no step has been refused) and publishes it."""
        t = time.perf_counter()
        if self.lead:
            ok = self.ahead.pop(step, True)
            later = ok and bool(decide())
            self.ahead[step + self.LAG] = later
            self.store.set(f'{self.prefix}/{step + self.LAG}', b'1' if later else b'0')
        else:
            ok = step < self.LAG or self.store.get(f'{self.prefix}/{step}') == b'1'
        self.seconds += time.perf_counter() - t
        return ok


class Group(NamedTuple):
    """This rank's place in a multi-card cell: the program's Mesh and the
    host-side store of the stop gates."""
    mesh: object            # imgcomp_cvpr_tpu_torch.parallel.mesh.Mesh
    store: object           # torch.distributed.TCPStore
    windows: itertools.count

    @property
    def lead(self) -> bool:
        return self.mesh.rank == 0

    def gate(self) -> Gate:
        """A new window's gate (each rank opens its windows in the same order)."""
        return Gate(self.store, self.lead, f'window{next(self.windows)}')

    def barrier(self) -> None:
        dev = self.mesh.device
        if dev.type == 'cuda':
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()

    def gather(self, obj) -> List:
        """Every rank's ``obj``, by rank (outside the window: it synchronizes)."""
        out = [None] * self.mesh.world_size
        dist.all_gather_object(out, obj)
        return out


def device_of(rank: int, device_type: str) -> torch.device:
    return torch.device('cuda', rank) if device_type == 'cuda' else torch.device('cpu')


def _watch_parent(ppid: int) -> None:
    while True:
        time.sleep(1.0)
        if os.getppid() != ppid:
            os._exit(ORPHANED)


@contextlib.contextmanager
def joined(rank: int, world: int, device: torch.device, init_method: str, store_port: int):
    """This process as rank ``rank`` of the group: the program's process
    group and the gates' store, left again on exit."""
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    threading.Thread(target=_watch_parent, args=(os.getppid(),), daemon=True).start()
    mesh = mesh_lib.init_process_group(rank, world, device, init_method)
    try:
        store = dist.TCPStore('localhost', store_port, world, rank == 0,
                              timedelta(seconds=STORE_TIMEOUT_S))
        yield Group(mesh, store, itertools.count())
    finally:
        mesh_lib.destroy_process_group()


def rank_run(rank, world, init_method, store_port, device_type, bench, name, seed, seconds,
             trace, t_start, overrides):
    """One rank of one run of a multi-card cell (run.run_cell); rank 0's
    (result, stderr lines, the JAX side's modules loaded on any rank once
    the run is over) or None."""
    from perfbench import harness
    from perfbench.run import run_cell
    device = device_of(rank, device_type)
    with joined(rank, world, device, init_method, store_port) as group:
        out, lines = run_cell(bench, name, seed, seconds, trace, device, t_start, overrides,
                              group)
        found = group.gather(harness.forbidden_loaded())
    return (out, lines, sorted(set().union(*found))) if rank == 0 else None


def rank_readings(rank, world, init_method, store_port, device_type, bench, name, seeds,
                  control_seeds, seconds, overrides, faults, verbose):
    """One rank of control.readings over a multi-card cell; rank 0's readings."""
    from perfbench import control
    device = device_of(rank, device_type)
    log = print if verbose and rank == 0 else (lambda *_: None)
    with joined(rank, world, device, init_method, store_port) as group:
        return control.readings(bench, name, seeds, control_seeds, seconds, device, overrides,
                                log, faults, group)


def spawn(rank_fn, world: int, device_type: str, args, limit_s: Optional[float]):
    """rank_fn(rank, world, init_method, store_port, device_type, *args) on
    ``world`` fresh ranks through the program's mesh.spawn -> rank 0's
    result, or None after a message on standard error when a rank failed.
    On cards the kernels are built here first, once for all ranks. With
    ``limit_s`` a watchdog ends every rank and this process (exit code
    STALLED) once that many seconds have passed since the ranks started."""
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    if device_type == 'cuda':
        from imgcomp_cvpr_tpu_torch.ops.kernels import build as kbuild
        kbuild.build_all()
    init = f'tcp://localhost:{mesh_lib.free_port()}'
    store_port = mesh_lib.free_port()
    watchdog = None
    if limit_s is not None:
        watchdog = threading.Timer(limit_s, _stalled, args=(limit_s,))
        watchdog.daemon = True
        watchdog.start()
    try:
        return mesh_lib.spawn(rank_fn, world, (world, init, store_port, device_type) + tuple(args))
    except Exception:       # a rank raised or died: mesh.spawn has ended the others
        sys.stderr.write(f'perfbench: a rank of {world} failed; the run is ended:\n'
                         f'{traceback.format_exc()}')
        sys.stderr.flush()
        return None
    finally:
        if watchdog is not None:
            watchdog.cancel()


def _stalled(limit_s: float) -> None:
    children = multiprocessing.active_children()
    for p in children:
        p.kill()
    for p in children:
        p.join(timeout=10.0)
    sys.stderr.write(f'perfbench: the ranks did not finish within {limit_s:.0f} s; '
                     f'{len(children)} rank process(es) ended\n')
    sys.stderr.flush()
    os._exit(STALLED)

