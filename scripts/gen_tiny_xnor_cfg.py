"""Write the tiny-yolo-obj_xnor-416 network definition to
``tests/data/tiny-yolo-obj_xnor.cfg``.

The topology is darknet's public ``cfg/tiny-yolo-voc.cfg`` (J. Redmon,
pjreddie/darknet): nine convolutions, 3x3/s1/p1 with batch norm and leaky,
each of the first six followed by a 2x2 maxpool (stride 2, the last one
stride 1), widths 16, 32, 64, 128, 256, 512, then 1024 and 1024, a dense 1x1
linear conv and a ``[region]`` head, at 416x416. As in AlexeyAB/yolo2_light's
``bin/tiny-yolo-obj_xnor.cfg``, the seven 3x3 convs after the dense first
one carry ``xnor=1`` and ``bin_output=1``: 16 layers, 9 convs, the head at
layer 15, the first conv dense.

What could not be taken from anywhere: the obj cfg's class count and
anchors. They are tiny-yolo-voc's (``classes=20``, ``num=5``, the five VOC
anchors, ``filters=125`` in the head conv). The 13x13 widths follow the
9-conv count of the reference cfg (512 -> 1024 -> 1024). It is generated
here instead of copied so that no file has to be fetched.

Usage: ``python scripts/gen_tiny_xnor_cfg.py [out_path]``.
"""

from __future__ import annotations

import os
import sys

ANCHORS = "1.08,1.19,  3.42,4.41,  6.63,11.38,  9.42,5.11,  16.62,10.52"

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
max_batches = 40200
policy=steps
steps=-1,100,20000,30000
scales=.1,10,.1,.1
"""

REGION = f"""[region]
anchors = {ANCHORS}
bias_match=1
classes=20
coords=4
num=5
softmax=1
jitter=.2
rescore=1

object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1

absolute=1
thresh = .6
random=1
"""


def conv(filters: int, xnor: bool) -> str:
    bits = "xnor=1\nbin_output=1\n" if xnor else ""
    return (f"[convolutional]\nbatch_normalize=1\n{bits}filters={filters}\n"
            "size=3\nstride=1\npad=1\nactivation=leaky\n")


def maxpool(stride: int) -> str:
    return f"[maxpool]\nsize=2\nstride={stride}\n"


def sections() -> list[str]:
    s = []
    for i, filters in enumerate((16, 32, 64, 128, 256, 512)):
        s += [conv(filters, xnor=i > 0), maxpool(1 if filters == 512 else 2)]
    s += [conv(1024, xnor=True), conv(1024, xnor=True)]
    s += ["[convolutional]\nsize=1\nstride=1\npad=1\nfilters=125\n"
          "activation=linear\n", REGION]
    return s


def render() -> str:
    return NET + "\n" + "\n".join(sections())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = argv[0] if argv else os.path.join(root, "tests", "data",
                                            "tiny-yolo-obj_xnor.cfg")
    with open(out, "w") as f:
        f.write(render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
