"""Host ms a block in the program's `batch.deliver` span
(`runtime.batch.BatchSession.run`, after the block's decode returns:
the per-stream frame loop, the result lines, the caller's callback, the
counters table) less its `ais.dispatch` spans."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("batch.deliver", less=("ais.dispatch",))
