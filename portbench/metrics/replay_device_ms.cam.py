"""replay_device_ms: device milliseconds of the CUDA graph's replays in the
profiled segment, from the first to the last of the events the program
captures at the stage bounds of its traced graph (the sum of its stage
times, so the launch's host time is left out), over the images the
program counted (``images``): device ms a frame."""
from portbench import spans

# the stages of the program's traced graph, first to last
STAGES = ("stage.ingest", "stage.network", "stage.decode", "stage.nms")


def read(ctx):
    return spans.device_ms_per_image(ctx, STAGES)
