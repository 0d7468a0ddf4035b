"""From a traced run's profiler events to what the per-layer readers read.

Device time is attributed to the harness's spans through torch.profiler's
CPU-to-kernel correlation: a kernel shares its correlation id with the CUDA
runtime call that launched it (the port's own kernels are launched through
ctypes, outside any PyTorch op), and the innermost span whose host interval
holds that call is the kernel's span. Kernels only count as device work;
copies run on their own engines and are listed apart, and the profiler's
copies of host ranges on the device timeline (the harness's spans,
``Optimizer.step#Adam.step``: a device event named as a host event) are
left out.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional

from perfbench.harness import SPAN_PREFIX

WINDOW = SPAN_PREFIX + 'window'
# CUDA runtime API calls on the host (cudaLaunchKernel, cuLaunchKernelEx, ...)
RUNTIME = re.compile(r'^cu(da)?[A-Z]')


def short_name(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + '...'


class TraceSummary:
    """Kernels of the traced window with their spans, the window, and the
    counts and computed work the runner hands over (per unit of work:
    a batch, a request or a step)."""

    def __init__(self, window_s: float, kernels: List, copies: Dict[str, float],
                 host_spans: Dict[str, float], gaps: Dict[str, float],
                 counts: Dict, work: Dict):
        self.window_s = window_s
        self.kernels = kernels          # (name, start_ns, end_ns, span or None)
        self.copies = copies
        self.host_spans = host_spans    # span -> host seconds
        self.gaps = gaps                # host span at an idle gap's start -> idle seconds
        self.counts = counts
        self.work = work
        self.busy_s = _union_s(kernels)

    @property
    def units(self) -> int:
        return self.counts.get('units', 0)

    def device_s(self, spans: Optional[List[str]] = None, pattern: Optional[str] = None) -> float:
        """Seconds of kernels launched inside any of ``spans`` (all when
        None) whose name matches the regular expression ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        return sum((e - s) for n, s, e, sp in self.kernels
                   if (spans is None or sp in spans) and (rx is None or rx.search(n))) / 1e9

    def breakdown(self) -> Dict:
        by_name = defaultdict(float)
        for n, s, e, _ in self.kernels:
            by_name[short_name(n)] += (e - s) / 1e9
        for n, v in self.copies.items():
            by_name[short_name(n)] += v
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {'device_ops': [[n, v] for n, v in ops], 'idle_gaps': [[n, v] for n, v in gaps]}


def _union_s(kernels) -> float:
    total, cur_s, cur_e = 0, None, None
    for _, s, e, _ in sorted(kernels, key=lambda k: k[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def summarize(events, counts: Dict, work: Dict) -> TraceSummary:
    """``events``: torch.profiler's kineto events of the traced run. A
    kernel's host launch time is its CUDA runtime call's (same correlation
    id), else the start of the op that its linked correlation id names."""
    op_start, rt_start, spans, kernels_raw, copies = {}, {}, [], [], defaultdict(float)
    win = None
    host_names = set()
    device = []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith('CUDA'):
            device.append(e)
        elif RUNTIME.match(name):
            rt_start[e.correlation_id()] = e.start_ns()
        else:
            host_names.add(name)
            op_start[e.correlation_id()] = e.start_ns()
            if name == WINDOW:
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name.startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name[len(SPAN_PREFIX):]))
    for e in device:
        name = e.name()
        if name.startswith(('Memcpy', 'Memset')):
            copies[name] += e.duration_ns() / 1e9
        elif name not in host_names:    # not a range's copy on the device timeline
            kernels_raw.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                                e.correlation_id(), e.linked_correlation_id()))
    if win is None:
        raise RuntimeError('the traced run has no window span')
    spans.sort()
    starts = [s for s, _, _ in spans]

    def span_at(t):
        """The innermost span holding host time t (spans nest a few deep)."""
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 8, -1), -1):
            if t <= spans[j][1]:
                return spans[j][2]
        return None

    kernels = []
    for name, s, e, corr, link in kernels_raw:
        if e < win[0] or s > win[1]:
            continue
        launch = rt_start.get(corr, op_start.get(link))
        kernels.append((name, max(s, win[0]), min(e, win[1]), span_at(launch)))
    host_spans = defaultdict(float)
    for s, e, n in spans:
        host_spans[n] += (e - s) / 1e9
    gaps = defaultdict(float)
    prev_end = win[0]
    for _, s, e, _ in sorted(kernels, key=lambda k: k[1]):
        if s > prev_end:
            gaps['host in ' + (span_at(prev_end) or 'no span')] += (s - prev_end) / 1e9
        prev_end = max(prev_end, e)
    if win[1] > prev_end:
        gaps['host in ' + (span_at(prev_end) or 'no span')] += (win[1] - prev_end) / 1e9
    return TraceSummary((win[1] - win[0]) / 1e9, kernels, dict(copies), dict(host_spans),
                        dict(gaps), counts, work)
