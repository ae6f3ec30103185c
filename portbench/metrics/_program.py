"""The program's own tracer (``gnuais_tpu_torch.runtime.trace``), read
for the per-layer metrics of a traced run.  The tracer records only
while ``torch.profiler`` records, and a traced run opens the profiler
around the window alone, so its totals are the window's; each metric
divides them by the blocks the batch session counted there
(``batch.blocks``).  A program without the tracer, a window with no
block, or a span the program did not take gives None."""

from __future__ import annotations

from typing import Optional, Sequence

BLOCKS = "batch.blocks"


def _tracer():
    try:
        from gnuais_tpu_torch.runtime import trace
    except ImportError:
        return None
    return trace


def span_ms(name: str, less: Sequence[str] = ()) -> Optional[float]:
    """Host ms a block in the span ``name``, less the spans ``less``
    taken inside it."""
    trace = _tracer()
    if trace is None:
        return None
    blocks = trace.counters().get(BLOCKS, 0)
    totals = trace.totals()
    if not blocks or name not in totals:
        return None
    inner = sum(totals[k].ms for k in less if k in totals)
    return (totals[name].ms - inner) / blocks


def count_per_block(name: str) -> Optional[float]:
    """The counter ``name`` a block."""
    trace = _tracer()
    if trace is None:
        return None
    counters = trace.counters()
    if not counters.get(BLOCKS) or name not in counters:
        return None
    return counters[name] / counters[BLOCKS]
