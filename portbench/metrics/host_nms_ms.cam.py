"""host_nms_ms: host milliseconds of the program's ``finish.nms`` span (the
host's exact greedy NMS, post/boxes.do_nms_sort, where device NMS is off),
the mean over the profiled segment's frames."""
from portbench import spans


def read(ctx):
    return spans.span_ms(ctx, "finish.nms")
