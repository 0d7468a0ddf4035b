"""perfbench/program_spans.py on a made-up trace and span list: idle time
attributed to the innermost program span open at each gap's start (and to
the spans holding it), the window's edges left out, host time as the union
of a span's intervals; and the readers built on it read nothing without
kernels or without the program's spans."""

import sys

import pytest

from perfbench import harness, program_spans
from perfbench.trace import TraceSummary

MS = 1_000_000     # ns
READERS = ('bias_rows_idle_ms.stream', 'codec_host_ms.stream', 'codec_wait_ms.stream',
           'ae_idle_ms.file', 'forward_idle_ms.train', 'backward_idle_ms.train',
           'optimizer_idle_ms.train')
# Window 0-1000 ms; kernels 100-200, 300-400, 350-500 (overlapping), 700-800:
# gaps 200-300 and 500-700; 0-100 and 800-1000 are the window's edges.
KERNELS = [('k', a * MS, b * MS, None) for a, b in ((100, 200), (300, 400), (350, 500),
                                                    (700, 800))]
# Spans of one thread: those of one depth do not overlap.
SPANS = [('codec.serialize', 100 * MS, 140 * MS, 0),
         ('ae.encode', 180 * MS, 260 * MS, 1),          # open at the gap at 200
         ('codec.parse', 270 * MS, 400 * MS, 1),
         ('planar.bias_rows', 480 * MS, 520 * MS, 1),   # open at the gap at 500
         ('train.forward', 150 * MS, 600 * MS, 0),      # holds the three above
         ('codec.parse', 610 * MS, 660 * MS, 1),
         ('train.backward', 600 * MS, 840 * MS, 0),     # no gap starts inside
         ('train.optimizer', 850 * MS, 950 * MS, 0),    # only the trailing edge
         ('codec.wait', 960 * MS, 990 * MS, 0)]


def summary(kernels=KERNELS):
    return TraceSummary(1.0, kernels, {}, {}, {}, {'units': 2}, {})


@pytest.fixture
def taken(monkeypatch):
    """The program's take() hands SPANS over once, then nothing."""
    from imgcomp_cvpr_tpu_torch.utils import spans
    calls = []

    def take():
        calls.append(1)
        return list(SPANS) if len(calls) == 1 else []
    monkeypatch.setattr(spans, 'take', take)
    return calls


def test_gaps_leave_out_the_edges_and_merge_overlaps():
    assert program_spans.gaps(KERNELS) == [(200 * MS, 100 * MS), (500 * MS, 200 * MS)]
    assert program_spans.gaps([]) == []


def test_open_spans_nest():
    names = program_spans.open_at(SPANS)
    assert names(200 * MS) == {'train.forward', 'ae.encode'}
    assert names(500 * MS) == {'train.forward', 'planar.bias_rows'}
    assert names(50 * MS) == frozenset()


def test_idle_goes_to_the_spans_open_at_the_gap(taken):
    t = summary()
    read = {m: harness.reader(m).read(t) for m in READERS}
    assert read['forward_idle_ms.train'] == pytest.approx(150.0)    # (100 + 200) / 2
    assert read['ae_idle_ms.file'] == pytest.approx(50.0)
    assert read['bias_rows_idle_ms.stream'] == pytest.approx(100.0)
    assert read['backward_idle_ms.train'] == 0.0
    assert read['optimizer_idle_ms.train'] == 0.0                   # the edge is left out
    # serialize 40 ms, parse 130 + 50: 220 ms over 2 units
    assert read['codec_host_ms.stream'] == pytest.approx(110.0)
    assert read['codec_wait_ms.stream'] == pytest.approx(15.0)
    assert len(taken) == 1          # one take() for every reader of the run


def test_a_span_the_run_lacks_reads_nothing(monkeypatch):
    from imgcomp_cvpr_tpu_torch.utils import spans
    monkeypatch.setattr(spans, 'take', lambda: [s for s in SPANS if s[0] != 'codec.wait'])
    assert harness.reader('codec_wait_ms.stream').read(summary()) is None


@pytest.mark.parametrize('metric', READERS)
def test_readers_read_nothing_without_kernels(metric, taken):
    assert harness.reader(metric).read(summary([])) is None


@pytest.mark.parametrize('metric', READERS)
def test_readers_read_nothing_without_the_programs_spans(metric, monkeypatch, tmp_path):
    """A checkout whose program keeps no spans: its utils package has no
    spans.py (here: a package path with nothing in it)."""
    import imgcomp_cvpr_tpu_torch.utils as utils
    monkeypatch.delattr(utils, 'spans', raising=False)
    monkeypatch.delitem(sys.modules, 'imgcomp_cvpr_tpu_torch.utils.spans', raising=False)
    monkeypatch.setattr(utils, '__path__', [str(tmp_path)])
    with pytest.raises(ImportError):
        from imgcomp_cvpr_tpu_torch.utils import spans  # noqa: F401
    assert harness.reader(metric).read(summary()) is None
