"""Host ms a block in the program's `pipeline.account` span
(`runtime.pipeline.BatchPipeline._account`): the per-stream counters and
the lists of CRC-passing frames, the readbacks excluded."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("pipeline.account")
