"""The plain reference the benchmark's check compares the program with:
plain PyTorch and NumPy, importing nothing of the program or of JAX.

This is the reference of every configuration whose file names none. A
configuration may name another package under ``portbench/`` (``"reference"``
in its file, a dotted name such as ``"tests.ref_relu"``), which then takes
this one's place in every step of a run; :func:`portbench.model.load_config`
resolves it. Such a package exports what this one does:

* ``parse(path) -> net``: the cfg, a net with ``w``, ``h``, ``c``,
  ``layers`` (each with ``index``, ``kind`` and its shapes), ``convs`` and
  ``heads``; ``count_params(net)``; ``conv_param_shapes(conv)``: name ->
  shape of each float parameter as darknet stores it;
* ``prepare(net, raw, arith, device)``, ``forward(net, prep, x, arith,
  logits=False)``: the heads, activated as the decode reads them or before
  that where ``logits`` (:func:`with_activations` gives this forward with
  darknet activations of a package's own); ``conv_arith(net, mode)``: conv
  index -> the arithmetic it is computed in under the configuration's
  mode;
* ``ingest``, ``decode``, ``correct_boxes``, ``nms``: the input and output
  stages (``post.py``);
* ``head_channels(head)``, ``objectness_and_best(net, head_logits)``: what
  sets the heads' sparsity and calibrates the objectness bias;
* optionally ``conv_work(net, mode)``: a list of ``portbench.work.ConvWork``
  (arithmetic, multiply-adds, bytes), where the package counts its convs'
  work itself. The card's peaks are ``portbench.work``'s alone: an
  arithmetic without one there gets no roofline share.
"""

import dataclasses
import types

import numpy as np
import torch

from . import net as _net
from .cfg import conv_param_shapes, count_params, parse
from .net import forward, integer_layers, prepare
from .post import correct_boxes, decode, ingest, nms


def conv_arith(net, mode: str) -> dict:
    """conv index -> the arithmetic it is computed in under ``mode``
    (``int8``: yolo2_light's -quantized, the first and the linear convs in
    float32; ``bf16``: every conv; ``f32``: every conv)."""
    if mode == "int8":
        ints = integer_layers(net)
        return {l.index: "int8" if l.index in ints else "f32"
                for l in net.convs}
    if mode not in ("bf16", "f32"):
        raise ValueError(f"unknown mode {mode!r}")
    return {l.index: mode for l in net.convs}


def with_activations(acts: dict):
    """This package's ``forward``, with each conv whose activation ``acts``
    names computed as a linear conv and then put through ``acts[name]``
    (a function of the float32 map). It runs ``net.forward``'s own code
    over that conv step, so a package that adds an activation shares every
    other step with this one."""
    def conv(l, q, x, arith):
        act = acts.get(l.activation)
        if act is None:
            return _net._conv(l, q, x, arith)
        return act(_net._conv(dataclasses.replace(l, activation="linear"),
                              q, x, arith))
    code = _net.forward
    return types.FunctionType(code.__code__, {**vars(_net), "_conv": conv},
                              code.__name__, code.__defaults__)


def head_channels(head) -> list:
    """Per anchor of a yolo head, (its box channels as a slice, its
    objectness channel): each anchor's ``5 + classes`` channels start with
    x, y, w, h and the objectness."""
    entries = head.c // head.n
    return [(slice(a * entries, a * entries + 4), a * entries + 4)
            for a in range(head.n)]


def objectness_and_best(net, head_logits: list) -> tuple:
    """(objectness logits, best class probabilities): float64 NumPy arrays
    ``[B, N]`` over every candidate of the heads that ``forward(...,
    logits=True)`` gives, the classes through the logistic as darknet's
    yolo layer puts them."""
    zs, bests = [], []
    for h in head_logits:
        zs.append(h[..., 4].double().flatten(1).cpu().numpy())
        bests.append(torch.sigmoid(h[..., 5:].double()).amax(-1)
                     .flatten(1).cpu().numpy())
    return np.concatenate(zs, 1), np.concatenate(bests, 1)
