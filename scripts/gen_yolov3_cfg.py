"""Write darknet's YOLOv3-416 network definition to ``tests/data/yolov3.cfg``.

The topology is the public ``cfg/yolov3.cfg`` of darknet (J. Redmon,
pjreddie/darknet; shipped unchanged as ``bin/yolov3.cfg`` in
AlexeyAB/yolo2_light): the darknet53 backbone (52 convolutions, 23 residual
shortcuts) followed by three yolo heads at strides 32/16/8 with masks
6,7,8 / 3,4,5 / 0,1,2 over the nine COCO anchors, 80 classes, at 416x416.
It is generated here instead of copied so that no file has to be fetched.

Usage: ``python scripts/gen_yolov3_cfg.py [out_path]``.
"""

from __future__ import annotations

import os
import sys

ANCHORS = "10,13,  16,30,  33,23,  30,61,  62,45,  59,119,  116,90,  156,198,  373,326"

NET = """[net]
# Testing
batch=1
subdivisions=1
width=416
height=416
channels=3
momentum=0.9
decay=0.0005
angle=0
saturation = 1.5
exposure = 1.5
hue=.1

learning_rate=0.001
burn_in=1000
max_batches = 500200
policy=steps
steps=400000,450000
scales=.1,.1
"""


def conv(filters: int, size: int, stride: int = 1, bn: bool = True,
         activation: str = "leaky") -> str:
    bn_line = "batch_normalize=1\n" if bn else ""
    return (f"[convolutional]\n{bn_line}filters={filters}\nsize={size}\n"
            f"stride={stride}\npad=1\nactivation={activation}\n")


def shortcut() -> str:
    return "[shortcut]\nfrom=-3\nactivation=linear\n"


def yolo(mask: str) -> str:
    return (f"[yolo]\nmask = {mask}\nanchors = {ANCHORS}\nclasses=80\nnum=9\n"
            "jitter=.3\nignore_thresh = .7\ntruth_thresh = 1\nrandom=1\n")


def route(layers: str) -> str:
    return f"[route]\nlayers = {layers}\n"


def head(width: int, mask: str) -> list[str]:
    """Three 1x1/3x3 pairs, the linear 255-filter detector conv, the yolo layer."""
    out = []
    for _ in range(3):
        out += [conv(width, 1), conv(2 * width, 3)]
    out += [conv(255, 1, bn=False, activation="linear"), yolo(mask)]
    return out


def yolov3_sections() -> list[str]:
    s = [conv(32, 3)]
    for filters, blocks in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        s.append(conv(filters, 3, stride=2))                  # downsample
        for _ in range(blocks):
            s += [conv(filters // 2, 1), conv(filters, 3), shortcut()]
    s += head(512, "6,7,8")                                   # stride 32
    s += [route("-4"), conv(256, 1), "[upsample]\nstride=2\n",
          route("-1, 61")]
    s += head(256, "3,4,5")                                   # stride 16
    s += [route("-4"), conv(128, 1), "[upsample]\nstride=2\n",
          route("-1, 36")]
    s += head(128, "0,1,2")                                   # stride 8
    return s


def render() -> str:
    return NET + "\n" + "\n".join(yolov3_sections())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = argv[0] if argv else os.path.join(root, "tests", "data", "yolov3.cfg")
    with open(out, "w") as f:
        f.write(render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
