"""The port's tracer: named spans and counters at the layer boundaries
of the program, recorded while a ``torch.profiler`` records and only
then.

- ``span(name, mark=False)``: a context that adds its host time
  (``time.perf_counter_ns``) and one call to ``name``.  Spans never
  synchronise the device, so a span's time is host time, the waits
  inside it included.  With ``mark`` the span is also the
  ``torch.profiler.record_function`` annotation ``gnuais.<name>``, so
  that the profiler's trace holds it on the clock of the device's
  kernels and copies: for spans taken a few times a block, never once a
  message (an annotation costs microseconds).
- ``count(name, n)``: adds ``n`` to the integer ``name``.
- ``totals()``, ``counters()``: the sums; ``reset()`` clears them;
  ``summary()``: one line for each span and one for the counters.

The one switch is the profiler: ``torch.autograd.profiler``'s module
flag ``_is_profiler_enabled``, which ``torch.profiler.profile`` sets
while it records.  With it off, ``span`` returns one shared no-op
context and ``count`` returns at once: no clock is read and no
``record_function`` is made.  So the CLI's ``--profile`` and a traced
benchmark run get the spans, and every other run pays a flag read a
call.  One instance serves the process (``TRACER``; the module's
functions are its methods).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "gnuais."
BLOCKS = "batch.blocks"


class SpanTotal(NamedTuple):
    calls: int
    ms: float


# the context ``span`` returns while no profiler records
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "mark", "t0")

    def __init__(self, tracer: "Tracer", name: str, mark: bool):
        self.tracer = tracer
        self.name = name
        self.mark = (torch.profiler.record_function(PREFIX + name)
                     if mark else None)

    def __enter__(self):
        if self.mark is not None:
            self.mark.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = self.tracer
        t._ns[self.name] += time.perf_counter_ns() - self.t0
        t._calls[self.name] += 1
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


class Tracer:
    """Span times, call counts and counters by name, summed."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._ns: Dict[str, int] = defaultdict(int)
        self._calls: Dict[str, int] = defaultdict(int)
        self._counts: Dict[str, int] = defaultdict(int)

    def span(self, name: str, mark: bool = False):
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name, mark)

    def count(self, name: str, n: int = 1) -> None:
        if _profiler._is_profiler_enabled:
            self._counts[name] += n

    def totals(self) -> Dict[str, SpanTotal]:
        return {k: SpanTotal(c, self._ns[k] / 1e6)
                for k, c in self._calls.items()}

    def counters(self) -> Dict[str, int]:
        return dict(self._counts)

    def summary(self) -> List[str]:
        """One line for each span (calls, total ms and, where the batch
        session ran blocks, ms a block) and one for the counters."""
        blocks = self._counts.get(BLOCKS, 0)
        lines = []
        for name, (calls, ms) in sorted(self.totals().items()):
            per = f", {ms / blocks:.3f} ms a block" if blocks else ""
            lines.append(f"span {name}: {calls} calls, {ms:.3f} ms{per}")
        lines.append("counters: " + (", ".join(
            f"{k} {v}" for k, v in sorted(self._counts.items())) or "none"))
        return lines


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
totals = TRACER.totals
counters = TRACER.counters
reset = TRACER.reset
summary = TRACER.summary
