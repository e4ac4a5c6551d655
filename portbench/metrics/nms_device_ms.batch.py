"""nms_device_ms: device milliseconds an image of the NMS kernels in the
profiled segment. Kernels timed: K7, csrc/nms_order.cu's
nms_order_kernel, and csrc/nms_walk.cu's nms_walk_kernel."""
from portbench.readers import kernel_ms_per_image

KERNELS = r"\bnms_(order|walk)_kernel\b"


def read(ctx):
    return kernel_ms_per_image(ctx, KERNELS)
