"""Host ms a block in `BatchPipeline.drain`: the read-back, the native
drain and the accounting (the step synchronised before it)."""

from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "drain")
