"""A cell on several cards, on the CPU: four gloo ranks at a tiny size
(a global batch of fourteen 48x48 crops, padded to sixteen: four a rank),
started through the program's parallel/mesh.py
as on the cards. The check passes the program and fails the control (the
TF32 reference in the program's place), half of the batch left out, the
gradients' all-reduce left out and a step that leaves the state unchanged;
a rank that dies or stalls ends the run with a non-zero exit.

The cell is `k3-train-dp4`, the program's data-parallel training over four
cards, with its traffic and limits files under perfbench/."""

import contextlib
import os
import signal
import subprocess
import sys
import time

import pytest

from perfbench import control, harness, ranks
from perfbench.run import run_ranks

BENCH = harness.load_benchmark()
CELLS = [w['name'] for w in BENCH['workloads'] if w['chips'] > 1]
SEED = 2 ** 31 + 977
# 48x48, not the one-card tests' 32x32: there MS-SSIM's coarsest scale is
# 2x2, and the one-card program at a batch of 8 reads loss gaps of 3.9e-4 to
# 8.3e-3 against the reference over four seeds, the ranks the same. Fourteen
# crops are padded to sixteen, as train_loop.py pads the configuration's 30
# to 32 (two rows repeated). At such sizes the third step's loss gap swings
# with the batch (Adam's first step is about lr x sign(g)): at this seed 14
# crops read 9.7e-4, 8 read 5.6e-4 and 6 read 4.5e-3, over the 0.003 limit
# set at the cell's own size; the first step's gap stays under 1e-6.
TINY = {'batch': 14, 'crop': [48, 48]}


def _limits(cell):
    return harness.load_json(f'perfbench/limits/{cell}.json')


def _run(cell, trace=0, rank_fn=None, limit_s=None):
    w = harness.workload(BENCH, cell)
    return run_ranks(BENCH, cell, SEED, 0.1, trace, time.perf_counter(), w['chips'], 'cpu',
                     TINY, rank_fn, limit_s)


@contextlib.contextmanager
def unchanged_state():
    """Fault: the optimizer's step leaves every parameter as it was."""
    from imgcomp_cvpr_tpu_torch.training import optimizers as opt_lib
    step = opt_lib.GroupedOptimizer.step
    opt_lib.GroupedOptimizer.step = lambda self: None
    try:
        yield
    finally:
        opt_lib.GroupedOptimizer.step = step


def _faults():
    from perfbench.runners import train
    return {'unchanged_state': unchanged_state, **train.FAULTS}


def faulty_rank(rank, world, init, port, fault, *args):
    """ranks.rank_run with ``fault`` planted in this rank."""
    with _faults()[fault]():
        return ranks.rank_run(rank, world, init, port, *args)


def dying_rank(rank, world, init, port, how, *args):
    """ranks.rank_run, whose rank 1 dies ('kill') or hangs ('stall') in its
    first training step."""
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
    if rank == 1:
        def step(self, state, batch):
            if how == 'kill':
                os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(3600)
        trainer_lib.Trainer.train_step = step
    return ranks.rank_run(rank, world, init, port, *args)


def jax_rank(rank, world, init, port, which, *args):
    """ranks.rank_run, whose rank ``which`` holds a stand-in for a module
    of the JAX side in sys.modules."""
    import types
    if rank == which:
        sys.modules['flax'] = types.ModuleType('flax')
    return ranks.rank_run(rank, world, init, port, *args)


def _with(fn, arg):
    """A rank function taking ``arg`` before the run's own arguments."""
    import functools
    return functools.partial(_shifted, fn, arg)


def _shifted(fn, arg, rank, world, init, port, *args):
    return fn(rank, world, init, port, arg, *args)


@pytest.mark.parametrize('cell', CELLS)
def test_cell_is_correct_on_cpu(cell):
    out, lines, found = _run(cell)
    assert out['correct'], out['checks']
    assert set(out['checks']) == set(_limits(cell)) and 'replica_gap_max' in out['checks']
    assert out['checks']['replica_gap_max']['value'] == 0.0
    assert list(out)[-1] == 'checks' and lines[-1].startswith('check ')
    want = {m['name'] for m in harness.metrics_of(BENCH, 'end_to_end', cell)}
    assert set(out['metrics']) == want
    if 'memory_peak_gb' in want:
        assert out['metrics']['memory_peak_gb']['value'] == \
            out['device']['memory_peak_bytes'] / 1e9
    assert out['device']['count'] == harness.workload(BENCH, cell)['chips']
    assert out['attempted'] >= 1 and out['failed'] == 0 and not found
    ranks_seen = [ln for ln in lines if ln.startswith('rank ')]
    assert len(ranks_seen) == out['device']['count']


@pytest.mark.parametrize('cell', CELLS)
def test_traced_run_reads_no_device_metric_on_cpu(cell):
    """On the CPU no reader of the device's trace finds a kernel; the host
    spans and the host's clock read."""
    out, _, _ = _run(cell, trace=1)
    per_layer = {m['name']: m['source'] for m in harness.metrics_of(BENCH, 'per_layer', cell)}
    assert out['correct'] and set(out['metrics']) == {
        n for n, src in per_layer.items() if src != 'device_trace'}
    assert out['device']['busy_s'] == 0.0 and out['device']['window_s'] > 0


@pytest.mark.parametrize('cell', CELLS)
def test_control_and_faults_are_not_correct(cell):
    """The TF32 control, half of the batch and the gradients' all-reduce
    left out each fail; the last fails both on the first gradient and on
    the replicas' gap."""
    res = control.readings_on_ranks(BENCH, cell, [SEED], 1, 0.0, 'cpu', TINY,
                                    faults=['half_batch', 'no_grad_all_reduce'], verbose=False)
    limits = _limits(cell)
    assert harness.judge(res['program'][0]['numbers'], limits)[0]
    assert not harness.judge(res['control'][0]['numbers'], limits)[0]
    assert not harness.judge(res['fault:half_batch'][0]['numbers'], limits)[0]
    nums = res['fault:no_grad_all_reduce'][0]['numbers']
    assert not harness.judge(nums, limits)[0]
    assert nums['replica_gap_max'] > limits['replica_gap_max']
    assert nums['grad_gap_max'] > limits['grad_gap_max']


@pytest.mark.parametrize('fault', ['unchanged_state', 'half_batch', 'no_grad_all_reduce'])
@pytest.mark.parametrize('cell', CELLS)
def test_run_with_a_fault_is_not_correct(cell, fault):
    """A whole run, every rank with the fault planted under the timed path."""
    out, _, _ = _run(cell, rank_fn=_with(faulty_rank, fault))
    assert not out['correct']


@pytest.mark.parametrize('cell', CELLS)
def test_killed_rank_ends_the_run(cell):
    t = time.perf_counter()
    assert _run(cell, rank_fn=_with(dying_rank, 'kill'), limit_s=120) is None
    assert time.perf_counter() - t < 120


@pytest.mark.parametrize('cell', CELLS)
def test_stalled_rank_ends_the_run(cell):
    """The watchdog ends the ranks and the process that started them (exit
    code ranks.STALLED), in a process of its own."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f'import sys; sys.path[:0] = [{harness.ROOT!r}, {here!r}]\n'
            'import test_perfbench_dp as t\n'
            f'print(t._run({cell!r}, rank_fn=t._with(t.dying_rank, "stall"), limit_s=30))\n')
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=150)
    assert proc.returncode == ranks.STALLED, proc.stderr[-2000:]
    assert 'did not finish within 30 s' in proc.stderr
    assert time.perf_counter() - t < 150




@pytest.mark.parametrize('cell', CELLS)
def test_jax_side_on_any_rank_is_found(cell):
    """A module of the JAX side loaded on rank 1 alone reaches the process
    that prints the result, which then refuses the run (run.main)."""
    out, _, found = _run(cell, rank_fn=_with(jax_rank, 1))
    assert out['correct'] and found == ['flax']


def test_all_reduce_idle_reader():
    from perfbench.metrics import all_reduce_idle_ms
    from perfbench.trace import TraceSummary
    kernels = [('ncclDevKernel_AllReduce_Sum_f32_RING_LL', 0, 2_000_000, None),
               ('void conv_kernel', 5_000_000, 9_000_000, None)]
    t = TraceSummary(0.01, kernels, {}, {}, {}, {'units': 2}, {})
    t.program_spans = [('train.all_reduce', 1_000_000, 6_000_000, 0)]
    assert all_reduce_idle_ms.read(t) == pytest.approx(1.5)


def test_nccl_readers():
    from perfbench.metrics import nccl_calls, nccl_ms
    from perfbench.trace import TraceSummary
    kernels = [('ncclDevKernel_AllReduce_Sum_f32_RING_LL', 0, 2_000_000, 'train.forward'),
               ('ncclDevKernel_Broadcast_RING_LL', 3_000_000, 3_500_000, 'fetch'),
               ('void conv_kernel', 4_000_000, 9_000_000, 'train.forward')]
    t = TraceSummary(0.01, kernels, {}, {}, {}, {'units': 2}, {})
    assert nccl_ms.read(t) == pytest.approx(1.25) and nccl_calls.read(t) == 1.0
    none = TraceSummary(0.01, kernels[2:], {}, {}, {}, {'units': 2}, {})
    assert nccl_ms.read(none) is None and nccl_calls.read(none) is None


def test_img_per_s_reader():
    """The traced window's images over its length; nothing without images."""
    from perfbench.metrics import img_per_s
    from perfbench.trace import TraceSummary
    t = TraceSummary(2.5, [], {}, {}, {}, {'units': 4, 'images': 120}, {})
    assert img_per_s.read(t) == pytest.approx(48.0)
    assert img_per_s.read(TraceSummary(2.5, [], {}, {}, {}, {'units': 4}, {})) is None
    assert img_per_s.read(TraceSummary(0.0, [], {}, {}, {}, {'units': 4, 'images': 120},
                                       {})) is None
