"""Host ms a block in the program's `ais.parse` spans
(`ais.dispatcher.ChannelDispatcher.dispatch`): the parser and the stdout
line, every message summed."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms("ais.parse")
