"""h2d_ms: host milliseconds of the program's ``dispatch.h2d`` span (the
copy of a frame to the card; from pageable memory it waits for the work
queued before it), the mean over the profiled segment's frames."""
from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "dispatch.h2d")
