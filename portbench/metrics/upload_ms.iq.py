"""Host ms a block in the program's `iq.upload` span
(`runtime.batch.BatchSession`): the staged I and Q rails copied to the
device, from page-locked memory on the card."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("iq.upload")
