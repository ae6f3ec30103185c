"""MB a block that the program's drain reads back from the device
(its `pipeline.d2h_bytes` counter, over 10**6)."""

from portbench.metrics._program import count_per_block


def read(ctx):
    value = count_per_block("pipeline.d2h_bytes")
    return None if value is None else value / 1e6
