"""Named spans inside the port, recorded only while a torch profiler records.

``with span('codec.wait'):`` marks a stretch of the caller's work. While no
torch profiler records, ``span`` returns one shared null context: the cost
is one read of the profiler's own module flag, and no setting turns spans
on or off. While one records (``torch.profiler.profile``, as
``tools/profile_codec.py --trace`` and ``train_loop``'s ``--profile_steps``
start it), a span is two things:

- a ``torch.profiler.record_function`` range named ``ic.<name>``, so that
  the profiler's Chrome trace shows it above the ops and kernels it holds;
- an entry ``(name, start_ns, end_ns, depth)`` in a list kept in memory,
  stamped on ``time.time_ns()``, the Unix-time clock that the profiler's
  events carry (``start_ns()``). ``depth`` counts the spans open on the
  same thread when it began, so nested spans can be told apart.

``take()`` hands the list over and starts a new one: call it when a
profiling session has ended to read that session's spans, and once before
a session to drop what an earlier one left. Spans of one thread nest;
the port opens them on the caller's thread only.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Tuple

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = 'ic.'
_NULL = contextlib.nullcontext()
_spans: List[Tuple[str, int, int, int]] = []
_depth = threading.local()


class _Span:
    __slots__ = ('name', 'range', 'start', 'depth')

    def __init__(self, name: str):
        self.name = name
        self.range = record_function(PREFIX + name)

    def __enter__(self):
        self.depth = getattr(_depth, 'n', 0)
        _depth.n = self.depth + 1
        self.start = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _spans.append((self.name, self.start, time.time_ns(), self.depth))
        _depth.n = self.depth
        return False


def span(name: str):
    """A context that records the span ``name`` while a torch profiler
    records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def take() -> List[Tuple[str, int, int, int]]:
    """The spans recorded since the last call, in the order they ended;
    the list starts anew."""
    global _spans
    out, _spans = _spans, []
    return out
