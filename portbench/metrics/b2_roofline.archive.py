"""Kernel B2's share of its roofline: the bound of its calls in the
traced window (portbench.card: 71 float32 operations a valid sample,
bytes read and written once) over its device time there (torch.profiler),
in %."""

from portbench.readers import b2_roofline


def read(ctx):
    return b2_roofline(ctx)
