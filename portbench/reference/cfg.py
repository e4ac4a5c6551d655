"""Darknet cfg parsing for the plain reference.

Reads the sections the benchmark's networks use (``[net]``,
``[convolutional]``, ``[maxpool]``, ``[shortcut]``, ``[route]``,
``[upsample]``, ``[yolo]``) and works out every layer's input and output
shape as darknet does (``parse_network_cfg``, src/parser.c of
pjreddie/darknet): a conv pads ``size // 2`` where ``pad=1``, a maxpool
pads ``size - 1`` in all unless ``padding=`` says otherwise, route and
shortcut indices may be negative (relative to the layer).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Layer:
    kind: str                 # conv, maxpool, shortcut, route, upsample, yolo
    index: int
    h: int
    w: int
    c: int
    out_h: int
    out_w: int
    out_c: int
    size: int = 0
    stride: int = 1
    pad: int = 0              # conv: per side; maxpool: darknet's total
    n: int = 0                # conv filters; yolo: anchors in its mask
    batch_normalize: bool = False
    activation: str = "linear"
    sources: tuple = ()       # route: layer indices; shortcut: (from,)
    mask: tuple = ()
    anchors: tuple = ()
    classes: int = 0


@dataclass
class Net:
    w: int
    h: int
    c: int
    layers: list
    input_calibration: list = field(default_factory=list)

    @property
    def convs(self) -> list:
        return [l for l in self.layers if l.kind == "conv"]

    @property
    def heads(self) -> list:
        return [l for l in self.layers if l.kind == "yolo"]


def _sections(text: str) -> list:
    out = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            out.append((line.strip("[]").strip(), {}))
        elif "=" in line and out:
            k, v = line.split("=", 1)
            out[-1][1][k.strip()] = v.strip()
    return out


def _ints(v: str) -> tuple:
    return tuple(int(t) for t in v.replace(" ", "").split(",") if t)


def parse(path: str) -> Net:
    with open(path) as f:
        sections = _sections(f.read())
    if not sections or sections[0][0] != "net":
        raise ValueError(f"{path}: the first section is not [net]")
    net_opts = sections[0][1]
    h, w = int(net_opts["height"]), int(net_opts["width"])
    c = int(net_opts.get("channels", 3))
    calib = [float(t) for t in
             net_opts.get("input_calibration", "").replace(" ", "").split(",")
             if t]
    net = Net(w=w, h=h, c=c, layers=[], input_calibration=calib)
    for kind, o in sections[1:]:
        i = len(net.layers)

        def at(rel: int) -> int:
            return rel if rel >= 0 else i + rel

        if kind == "convolutional":
            size, stride = int(o.get("size", 1)), int(o.get("stride", 1))
            pad = (size // 2 if int(o.get("pad", 0))
                   else int(o.get("padding", 0)))
            n = int(o["filters"])
            oh = (h + 2 * pad - size) // stride + 1
            ow = (w + 2 * pad - size) // stride + 1
            l = Layer("conv", i, h, w, c, oh, ow, n, size=size, stride=stride,
                      pad=pad, n=n,
                      batch_normalize=bool(int(o.get("batch_normalize", 0))),
                      activation=o.get("activation", "logistic"))
        elif kind in ("maxpool", "max"):
            size = int(o.get("size", 1))
            stride = int(o.get("stride", 1))
            pad = int(o.get("padding", size - 1))
            l = Layer("maxpool", i, h, w, c, (h + pad - size) // stride + 1,
                      (w + pad - size) // stride + 1, c, size=size,
                      stride=stride, pad=pad)
        elif kind == "shortcut":
            src = at(int(o["from"]))
            l = Layer("shortcut", i, h, w, c, h, w, c, sources=(src,),
                      activation=o.get("activation", "linear"))
        elif kind == "route":
            srcs = tuple(at(j) for j in _ints(o["layers"]))
            first = net.layers[srcs[0]]
            if any((net.layers[j].out_h, net.layers[j].out_w)
                   != (first.out_h, first.out_w) for j in srcs):
                raise ValueError(f"{path}: route {i} joins maps of "
                                 "different sizes")
            l = Layer("route", i, h, w, c, first.out_h, first.out_w,
                      sum(net.layers[j].out_c for j in srcs), sources=srcs)
        elif kind == "upsample":
            s = int(o.get("stride", 2))
            if float(o.get("scale", 1)) != 1.0:
                raise ValueError(f"{path}: upsample {i} has a scale")
            l = Layer("upsample", i, h, w, c, h * s, w * s, c, stride=s)
        elif kind == "yolo":
            mask = _ints(o["mask"])
            classes = int(o.get("classes", 20))
            if c != len(mask) * (5 + classes):
                raise ValueError(f"{path}: yolo {i} reads {c} channels")
            l = Layer("yolo", i, h, w, c, h, w, c, n=len(mask), mask=mask,
                      anchors=_ints(o["anchors"]), classes=classes)
        else:
            raise ValueError(f"{path}: section [{kind}] is not supported")
        net.layers.append(l)
        h, w, c = l.out_h, l.out_w, l.out_c
    return net


def conv_param_shapes(l: Layer) -> dict:
    """The float parameters of conv ``l`` as darknet stores them, HWIO
    weights: name -> shape."""
    out = {"weights": (l.size, l.size, l.c, l.n), "biases": (l.n,)}
    if l.batch_normalize:
        for k in ("scales", "rolling_mean", "rolling_variance"):
            out[k] = (l.n,)
    return out


def count_params(net: Net) -> int:
    total = 0
    for l in net.convs:
        for shape in conv_param_shapes(l).values():
            n = 1
            for d in shape:
                n *= d
            total += n
    return total
