"""Host ms a block in the program's `batch.assemble` span
(`runtime.batch.BatchSession.run`) in the IQ cell: the per-stream copies
of the I and Q rails into the session's kept staging buffer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("batch.assemble")
