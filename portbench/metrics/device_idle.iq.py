"""The device's idle share of the IQ cell's traced window: 1 less the
union of its busy intervals over the window (torch.profiler), in %."""

from portbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
