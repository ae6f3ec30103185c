"""Host ms a block in the program's `batch.assemble` span
(`runtime.batch.BatchSession.run`): the block's `np.zeros` and the
per-stream copies into it."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("batch.assemble")
