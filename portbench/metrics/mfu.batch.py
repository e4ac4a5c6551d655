"""mfu: every conv's operations (2 x multiply-adds, from the layer shapes)
at the published peak of its arithmetic (int8 1,979 TOP/s, bf16 989
TFLOP/s, float32 67 TFLOP/s), times the images completed a second in the
window, in % of one H100."""
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx)
