"""Host ms a block in the program's `ais.nmea` spans
(`ais.dispatcher.ChannelDispatcher.dispatch`): the NMEA encoder, every
message summed."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("ais.nmea")
