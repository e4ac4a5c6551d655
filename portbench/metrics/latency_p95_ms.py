"""latency_p95_ms: the 95th percentile (nearest rank) of every request of
the window, from the frame in host memory to its detections in host
memory."""
from portbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 95)
