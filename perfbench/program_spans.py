"""The program's own spans in a traced run, and the card's idle time under
them.

While a profiler records, the port keeps the spans it opens in memory
(``imgcomp_cvpr_tpu_torch/utils/spans.py``: name, start and end on the Unix
nanosecond clock that the profiler's events carry, nesting depth) and
``take()`` hands them over once. This module takes them once for each
TraceSummary and keeps them on it, so every reader of one traced run sees
the same spans. A checkout whose program keeps no spans gives None, and the
readers built on it read nothing.

Idle time is attributed by trace.py's rule: each gap between the window's
kernels goes to the innermost program span open at the gap's start, and
counts for every span that holds that one as well (``train.forward``
holds whatever the forward opens). The stretches before the window's
first kernel and after its last are left out: the summary keeps the
window's length, not its bounds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from perfbench.trace import _union_s as union_s    # (name, start_ns, end_ns, _) rows

Span = Tuple[str, int, int, int]      # name, start_ns, end_ns, depth


def spans_of(t) -> Optional[List[Span]]:
    """The program's spans of the traced run ``t`` (taken on first use)."""
    if not hasattr(t, 'program_spans'):
        try:
            from imgcomp_cvpr_tpu_torch.utils import spans
        except ImportError:     # a program without utils/spans.py
            t.program_spans = None
        else:
            t.program_spans = spans.take()
    return t.program_spans


def gaps(kernels) -> List[Tuple[int, int]]:
    """(start_ns, length_ns) of each stretch between the first kernel's
    start and the last one's end in which no kernel runs."""
    out, prev_end = [], None
    for _, s, e, _ in sorted(kernels, key=lambda k: k[1]):
        if prev_end is not None and s > prev_end:
            out.append((prev_end, s - prev_end))
        prev_end = e if prev_end is None else max(prev_end, e)
    return out


def open_at(spans: Sequence[Span]):
    """-> f(t_ns): the names of the spans open at t. Spans of one depth do
    not overlap (they are the caller's thread's), so each depth is one
    sorted list and one bisection."""
    levels = defaultdict(list)
    for name, s, e, d in spans:
        levels[d].append((s, e, name))
    index = []
    for d in sorted(levels):
        rows = sorted(levels[d])
        index.append(([s for s, _, _ in rows], rows))

    def names(t: int) -> FrozenSet[str]:
        found = []
        for starts, rows in index:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rows[i][1]:
                found.append(rows[i][2])
        return frozenset(found)
    return names


def idle_by_spans(t) -> Dict[FrozenSet[str], float]:
    """Idle seconds of the traced run by the set of program spans open at
    each gap's start (cached on ``t``)."""
    if not hasattr(t, 'program_idle'):
        names = open_at(spans_of(t) or ())
        idle = defaultdict(float)
        for start, length in gaps(t.kernels):
            idle[names(start)] += length / 1e9
        t.program_idle = dict(idle)
    return t.program_idle


def _readable(t, names: Sequence[str]) -> Optional[List[Span]]:
    """The run's spans named in ``names``, or None where the run has no
    kernels or units, or the program recorded none of them."""
    spans = spans_of(t)
    if not t.kernels or not t.units or not spans:
        return None
    mine = [sp for sp in spans if sp[0] in names]
    return mine or None


def idle_ms(t, names: Sequence[str]) -> Optional[float]:
    """Idle ms a unit of the card with any of the spans ``names`` open on
    the host."""
    if _readable(t, names) is None:
        return None
    want = set(names)
    s = sum(v for k, v in idle_by_spans(t).items() if k & want)
    return 1e3 * s / t.units


def host_ms(t, names: Sequence[str]) -> Optional[float]:
    """Host ms a unit inside any of the spans ``names`` (the union of their
    intervals, so a span inside another of them counts once)."""
    mine = _readable(t, names)
    return None if mine is None else 1e3 * union_s(mine) / t.units
