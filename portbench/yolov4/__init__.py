"""The plain reference of yolov4 (AlexeyAB/darknet's cfg/yolov4.cfg), for a
configuration that names it (``"reference": "yolov4"``).

Plain PyTorch in float32, importing nothing of the program or of JAX. It
reuses every function of the default package (``portbench/reference/``)
and adds what yolov4 has beyond yolov3:

* mish, AlexeyAB/darknet's activate_array_mish written out: the softplus
  with its threshold of 20 (``x`` above it, ``exp(x)`` below its negative),
  then tanh, then the product with ``x``; the forward is the default one
  (:func:`portbench.reference.with_activations`), so SPP's stride-1
  maxpools and the CSP and PAN routes run on its code;
* ``scale_x_y`` of each ``[yolo]`` head: :func:`parse` keeps it and
  :func:`decode` maps x and y after the logistic to ``x * s - 0.5 * (s -
  1)`` before the default decode, as darknet's forward_yolo_layer does
  (scal_add_cpu).

Departures from darknet, each below the comparison's reach: the softplus
between the thresholds is ``log1p(exp(x))`` where darknet writes
``logf(expf(x) + 1)``, and the tanh is ``torch.tanh`` where darknet writes
``2 / (1 + expf(-2 x)) - 1``: both agree to a few ulps near 0 and above,
and darknet's own forms lose precision as ``x`` falls below 0. Under
``int8`` (yolo2_light's -quantized, which has no mish) every mish conv runs
as the default package's int8 linear conv, then mish in float32, as the
program's mish epilogue does. The heads' NMS is do_nms_sort, which is
darknet's ``nms_kind=greedynms``. The cfg's training-only keys are not
read.
"""

import torch

from portbench.reference import (conv_arith, conv_param_shapes,  # noqa: F401
                                 correct_boxes, count_params, head_channels,
                                 ingest, nms, objectness_and_best,
                                 prepare, with_activations)
from portbench.reference import decode as _decode
from portbench.reference import parse as _parse
from portbench.reference.cfg import _sections

MISH_THRESHOLD = 20.0


def mish(x: torch.Tensor) -> torch.Tensor:
    """darknet's mish of a float32 map: ``x * tanh(softplus(x))``."""
    t = torch.full((), MISH_THRESHOLD, device=x.device)
    softplus = torch.where(x > t, x, torch.where(x < -t, torch.exp(x),
                                                 torch.log1p(torch.exp(x))))
    return x * torch.tanh(softplus)


forward = with_activations({"mish": mish})


def parse(path: str):
    """The default parse, each yolo head carrying its ``scale_x_y``
    (default 1)."""
    net = _parse(path)
    with open(path) as f:
        yolos = [o for kind, o in _sections(f.read())[1:] if kind == "yolo"]
    for l, o in zip(net.heads, yolos, strict=True):
        l.scale_x_y = float(o.get("scale_x_y", 1))
    return net


def _scaled(net, heads: list) -> list:
    """Each head's x and y through its ``scale_x_y``: ``x * s + b``, ``b =
    -0.5 * (s - 1)``, in float32 with two roundings."""
    out = []
    for l, hd in zip(net.heads, heads):
        s = torch.tensor(getattr(l, "scale_x_y", 1.0), dtype=torch.float32)
        if s == 1:
            out.append(hd)
            continue
        b = (torch.tensor(-0.5) * (s - 1)).to(hd.device)
        xy = hd[..., 0:2] * s.to(hd.device) + b
        out.append(torch.cat([xy, hd[..., 2:]], dim=-1))
    return out


def decode(net, heads: list, thresh: float) -> tuple:
    """The default decode of the heads with x and y scaled (:func:`_scaled`)."""
    return _decode(net, _scaled(net, heads), thresh)
