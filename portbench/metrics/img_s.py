"""img_s: images whose detections came back to host memory in the window,
over the window's seconds (the window closes when the last batch
dispatched before its end is collected)."""
from portbench.readers import images_per_s


def read(ctx):
    return images_per_s(ctx)
