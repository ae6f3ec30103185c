"""Host ms a block in the program's `pipeline.readback` spans
(`runtime.pipeline`'s drain): each device-to-host read of the step's
frames, with its wait for the device."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("pipeline.readback")
