"""Host ms a block in the `ais` layer: every stream's
`ChannelDispatcher.dispatch` (parse, stdout line, NMEA), summed."""

from portbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, "dispatch")
