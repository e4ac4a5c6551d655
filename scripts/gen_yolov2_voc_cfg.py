"""Write darknet's YOLOv2-VOC-416 network definition to
``tests/data/yolov2-voc.cfg``.

The topology is the public ``cfg/yolov2-voc.cfg`` of darknet (J. Redmon,
pjreddie/darknet; shipped as ``bin/yolov2-voc.cfg`` in AlexeyAB/yolo2_light):
the darknet19 backbone (18 convolutions with batch norm and leaky, five 2x2
maxpools of stride 2), two 3x3x1024 convs, the passthrough branch (``[route]
layers=-9``, a 1x1x64 conv, ``[reorg] stride=2``, ``[route] layers=-1,-4``:
1280 channels at 13x13), a 3x3x1024 conv, the linear 1x1x125 detector conv
and a ``[region]`` head over the five VOC anchors, 20 classes, at 416x416:
32 layers, 23 convs. It is generated here instead of copied so that no file
has to be fetched.

``render(size, width_div)`` gives the same topology at another input size
with every width but the detector conv's divided (the narrow nets of the CPU
tests).

Usage: ``python scripts/gen_yolov2_voc_cfg.py [out_path]``.
"""

from __future__ import annotations

import os
import sys

ANCHORS = ("1.3221,1.73145,  3.19275,4.00944,  5.05587,8.09892,  "
           "9.47112,4.84053,  11.2364,10.0071")


def net(size: int) -> str:
    return f"""[net]
# Testing
batch=1
subdivisions=1
width={size}
height={size}
channels=3
momentum=0.9
decay=0.0005
angle=0
saturation = 1.5
exposure = 1.5
hue=.1

learning_rate=0.001
burn_in=1000
max_batches = 80200
policy=steps
steps=40000,60000
scales=.1,.1
"""


REGION = f"""[region]
anchors = {ANCHORS}
bias_match=1
classes=20
coords=4
num=5
softmax=1
jitter=.3
rescore=1

object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1

absolute=1
thresh = .6
random=1
"""


def conv(filters: int, size: int, bn: bool = True,
         activation: str = "leaky") -> str:
    bn_line = "batch_normalize=1\n" if bn else ""
    return (f"[convolutional]\n{bn_line}filters={filters}\nsize={size}\n"
            f"stride=1\npad=1\nactivation={activation}\n")


MAXPOOL = "[maxpool]\nsize=2\nstride=2\n"


def sections(width_div: int = 1) -> list[str]:
    def w(filters: int) -> int:
        return filters // width_div

    s = [conv(w(32), 3), MAXPOOL, conv(w(64), 3), MAXPOOL]
    # darknet19's stages: 3x3 / 1x1 / 3x3 (/ 1x1 / 3x3) then a maxpool
    for filters, pairs in ((128, 1), (256, 1), (512, 2)):
        s.append(conv(w(filters), 3))
        for _ in range(pairs):
            s += [conv(w(filters // 2), 1), conv(w(filters), 3)]
        s.append(MAXPOOL)
    s.append(conv(w(1024), 3))
    for _ in range(2):
        s += [conv(w(512), 1), conv(w(1024), 3)]
    s += ["#######\n", conv(w(1024), 3), conv(w(1024), 3)]
    # the passthrough: the 26x26x512 output of layer 16, reorganised
    s += ["[route]\nlayers=-9\n", conv(w(64), 1), "[reorg]\nstride=2\n",
          "[route]\nlayers=-1,-4\n", conv(w(1024), 3),
          conv(125, 1, bn=False, activation="linear"), REGION]
    return s


def render(size: int = 416, width_div: int = 1) -> str:
    return net(size) + "\n" + "\n".join(sections(width_div))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = argv[0] if argv else os.path.join(root, "tests", "data",
                                            "yolov2-voc.cfg")
    with open(out, "w") as f:
        f.write(render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
