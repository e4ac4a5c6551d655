"""h2d_gb_s: the bytes of the frames copied to the card (the program's
``h2d_bytes`` counter) over the host time inside its ``dispatch.h2d``
spans, in the profiled segment, in GB/s: how fast the pageable copy of a
frame goes, waits included."""
from portbench import spans


def read(ctx):
    return spans.gb_per_s(ctx, "h2d_bytes", "dispatch.h2d")
