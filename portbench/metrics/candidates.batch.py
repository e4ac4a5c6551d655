"""candidates: the rows of the packed buffer that the pipeline's host
finish keeps a frame (any class score above zero, after the device NMS),
from the program's ``candidates`` and ``images`` counters over the
profiled segment: the rows the host corrects and formats."""
from portbench import spans


def read(ctx):
    return spans.counted_per_image(ctx, "candidates")
