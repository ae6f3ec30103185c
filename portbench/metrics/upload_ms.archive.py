"""Host ms a block in `runtime.pipeline._upload`, the pageable host to
device copy, synchronised after."""

from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "upload")
