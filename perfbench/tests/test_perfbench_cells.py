"""Each one-card cell end to end on the CPU at a tiny size (two 32x48 crops
a batch, the program's plain PyTorch versions of its kernels), and the
check that decides ``correct``: it passes the program, and fails the
control (the reference one precision step below the configuration's, in the
program's place) and a run whose timed path alters an answer where it is
produced. The cells on several cards have theirs in test_perfbench_dp.py.
The ``cuda`` test does the same on the cards at every cell's own size."""

import time

import numpy as np
import pytest
import torch

from perfbench import control, harness
from perfbench.run import run_cell

BENCH = harness.load_benchmark()
ALL_CELLS = [w['name'] for w in BENCH['workloads']]
CELLS = [w['name'] for w in BENCH['workloads'] if w['chips'] == 1]
SEED = 2 ** 31 + 977


def _runner(cell):
    w = harness.workload(BENCH, cell)
    return harness.load_json(f'perfbench/traffic/{w["traffic"]}.json')['runner']


CODEC_CELLS = [c for c in CELLS if _runner(c) != 'train']
TRAIN_CELLS = [c for c in CELLS if _runner(c) == 'train']


def tiny(cell):
    """Two 32x48 crops a batch (32x32 for training: MS-SSIM's fifth scale
    needs 2 rows and 3 columns or more)."""
    return {'batch': 2, 'crop': [32, 32] if cell in TRAIN_CELLS else [32, 48]}


def _run(cell, trace=0, seconds=0.1):
    return run_cell(BENCH, cell, SEED, seconds, trace, torch.device('cpu'),
                    time.perf_counter(), tiny(cell))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_is_correct_on_cpu(cell):
    out, lines = _run(cell)
    assert out['correct'], out['checks']
    assert list(out)[-1] == 'checks' and lines[-1].startswith('check ')
    want = {m['name'] for m in harness.metrics_of(BENCH, 'end_to_end', cell)}
    assert set(out['metrics']) == want
    assert out['attempted'] >= 1 and out['failed'] == 0


def test_traced_run_reads_no_device_metric_on_cpu():
    out, _ = _run(CODEC_CELLS[0], trace=1)
    assert out['correct'] and out['metrics'] == {}
    assert out['device']['busy_s'] == 0.0 and out['device']['window_s'] > 0
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    res = control.readings(BENCH, cell, [SEED], 1, 0.1, torch.device('cpu'), tiny(cell),
                           log=lambda *_: None)
    limits = harness.load_json(f'perfbench/limits/{cell}.json')
    assert harness.judge(res['program'][0]['numbers'], limits)[0]
    assert not harness.judge(res['control'][0]['numbers'], limits)[0]


@pytest.mark.parametrize('cell', CODEC_CELLS)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    """The decode hands back one image's symbols shifted by one center."""
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    finish = codec_lib.LatentCodec.decode_batch_finish

    def altered(self, *args, **kwargs):
        syms = finish(self, *args, **kwargs)
        bad = syms.clone() if isinstance(syms, torch.Tensor) else np.array(syms)
        bad[0] = (bad[0] + 1) % self.pc.num_centers
        return bad
    monkeypatch.setattr(codec_lib.LatentCodec, 'decode_batch_finish', altered)
    out, _ = _run(cell)
    assert not out['correct']
    assert out['checks']['roundtrip_errors']['value'] > 0


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_unchanged_state_is_not_correct(cell, monkeypatch):
    """The optimizer's step leaves every parameter as it was."""
    from imgcomp_cvpr_tpu_torch.training import optimizers as opt_lib
    monkeypatch.setattr(opt_lib.GroupedOptimizer, 'step', lambda self: None)
    out, _ = _run(cell)
    assert not out['correct']
    assert out['checks']['change_gap_max']['value'] == pytest.approx(1.0)


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_half_batch_is_not_correct(cell):
    """The step's loss is the mean over half of the batch."""
    res = control.readings(BENCH, cell, [SEED], 1, 0.0, torch.device('cpu'), tiny(cell),
                           log=lambda *_: None, faults=['half_batch'])
    limits = harness.load_json(f'perfbench/limits/{cell}.json')
    assert not harness.judge(res['fault:half_batch'][0]['numbers'], limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ALL_CELLS)
def test_cell_on_the_card(cell):
    """At the cell's own size, one rank a card where it asks for several:
    two seeds of the program pass, the control fails (a few minutes a cell:
    set-up, two short windows, the reference)."""
    chips = harness.workload(BENCH, cell)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f'needs {chips} NVIDIA card(s)')
    if chips == 1:
        res = control.readings(BENCH, cell, [SEED, SEED + 1], 1, 2.0, torch.device('cuda', 0),
                               log=lambda *_: None)
    else:
        res = control.readings_on_ranks(BENCH, cell, [SEED, SEED + 1], 1, 2.0, 'cuda',
                                        verbose=False)
    limits = harness.load_json(f'perfbench/limits/{cell}.json')
    assert all(harness.judge(r['numbers'], limits)[0] for r in res['program'])
    assert not harness.judge(res['control'][0]['numbers'], limits)[0]
