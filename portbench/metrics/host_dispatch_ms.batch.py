"""host_dispatch_ms: host milliseconds of a DetectionPipeline.dispatch
call (the H2D of the uint8 frames and the graph's enqueue), the mean over
the window, from the harness's own spans around each call."""
from portbench.readers import dispatch_ms


def read(ctx):
    return dispatch_ms(ctx)
