"""host_finish_ms: host milliseconds of the pipeline's host finish of a
batch (the program's ``collect.finish`` span: for each frame the box
correction, the host NMS where device NMS is off, the detections), the
mean over the profiled segment's batches."""
from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "collect.finish")
