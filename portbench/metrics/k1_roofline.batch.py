"""k1_roofline: the least time of the int8 convs for the segment's images
(the larger of bytes over 3.35 TB/s and operations over 1,979 TOP/s, each
input read once and each output written once) over the device time of
the kernels that compute them, in %. Kernels timed: K1,
csrc/int8_conv.cu's int8_conv_kernel."""
from portbench.readers import kernel_roofline

KERNELS = r"\bint8_conv_kernel\b"


def read(ctx):
    return kernel_roofline(ctx, "int8", KERNELS)
