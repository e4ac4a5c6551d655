"""decode_device_ms: device milliseconds of the decode stage of the CUDA
graph's replays in the profiled segment (between the events the program
captures in a traced graph after the network and after the decode), over
the images the program counted: device ms a frame."""
from portbench import spans


def read(ctx):
    return spans.device_ms_per_image(ctx, ("stage.decode",))
