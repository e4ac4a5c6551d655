"""device_idle: the share of the profiled segment in which no kernel ran
on the card (the union of the kernels' intervals; copies do not count as
busy), in %."""
from portbench.readers import device_idle


def read(ctx):
    return device_idle(ctx)
