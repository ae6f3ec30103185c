"""Host ms a block in the program's `pipeline.unpack` span
(`runtime.pipeline`'s drain): the native drain that turns the frames'
register words into CRC-checked `Frame` objects."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("pipeline.unpack")
