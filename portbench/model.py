"""A configuration: its file, its weights from the seed, and the program
built from them.

A configuration file (``configs/<name>.json``) names the darknet cfg that
lies beside it, states the shape the cfg must have (input size, layers,
convs, classes, parameters) and how the program runs it (mode, int8
policy and engine, float type, and any other setting of the port's
``DetectionPipeline`` that the harness does not set itself).
:func:`load_config` refuses a cfg whose shape is not the stated one, so a
small net never runs under a full model's name.

Its plain reference is the package under ``portbench/`` that the file
names (``"reference"``, a dotted name; ``reference`` where it names none),
which exports :data:`INTERFACE` (``reference/__init__.py`` says what each
does). :func:`load_config` resolves it once and hands it on with the net
(``net.ref``), which every step that reads the net asks, so a new network
with a reference of its own is added as new files.

Weights are uniform random from the seed, made on the device in one call:
conv weights at darknet's He scale, batch-norm scales and variances in the
ranges of the port's ``random_params``, biases and batch-norm means at a
tenth of its ranges (:data:`SHIFT`). With its full ranges the shifts add
up through the 75 layers until a random yolov3's answers hardly depend on
its input: two frames' answers then differ by little more than bf16's
rounding does, and no comparison could tell an answer computed from the
wrong frame. Each head's box channels are damped so that boxes sit near
their anchors, and the objectness bias is set so that about the traffic's
number of candidates clears its threshold (``sparse_heads``,
``calibrate_obj_bias``, after ``chip_smoke.py``'s, with the reference's
forward in place of the program's). The objectness and class channels keep
their full scale: damped, every candidate's scores would sit within a
fraction of a percent of each other and of the threshold, where any
rounding apart from the reference's decides the threshold and the NMS.
"""

from __future__ import annotations

import hashlib
import importlib
import inspect
import json
import os

import numpy as np
import torch

HEAD_DAMP = 0.02          # of the heads' box channels
CALIB_FRAMES = 8          # pool frames the objectness bias is set on
SHIFT = 0.1               # biases and BN means, against random_params'
DEFAULT_REFERENCE = "reference"   # of a configuration that names none
INTERFACE = ("parse", "count_params", "conv_param_shapes", "prepare",
             "forward", "conv_arith", "ingest", "decode", "correct_boxes",
             "nms", "head_channels", "objectness_and_best")
# DetectionPipeline's arguments that the harness sets, not the program block
HARNESS_SETS = ("spec", "params", "thresh", "nms", "k", "device_nms",
                "device")


def sub_seed(seed: int, what: str) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{seed}/{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class ConfigError(ValueError):
    pass


def program_keys() -> set:
    """The keys a program block may hold: ``DetectionPipeline``'s
    arguments, less :data:`HARNESS_SETS` and its private ones."""
    from yolo2_light_tpu_torch.pipeline import DetectionPipeline
    return {k for k in inspect.signature(DetectionPipeline).parameters
            if k not in HARNESS_SETS and not k.startswith("_")}


def load_config(path: str) -> tuple:
    """(config dict, reference net) of a configuration file, the net
    carrying its reference package (``net.ref``), or :class:`ConfigError`
    where the package lacks the interface, the program block has a key
    the program does not take, or the cfg is not the shape the file
    states."""
    with open(path) as f:
        c = json.load(f)
    ref = importlib.import_module(
        f"{__package__}.{c.get('reference', DEFAULT_REFERENCE)}")
    lacks = [k for k in INTERFACE if not callable(getattr(ref, k, None))]
    if lacks:
        raise ConfigError(f"{c['name']}: the reference package "
                          f"{ref.__name__} lacks {lacks}")
    unknown = sorted(set(c["program"]) - program_keys())
    if unknown:
        raise ConfigError(f"{c['name']}: the program takes no {unknown}")
    cfg_path = os.path.join(os.path.dirname(path), c["cfg"])
    net = ref.parse(cfg_path)
    net.ref = ref
    got = {"input": [net.h, net.w, net.c], "layers": len(net.layers),
           "convs": len(net.convs),
           "classes": sorted({l.classes for l in net.heads}),
           "params": ref.count_params(net)}
    want = {k: c["shape"][k] for k in got}
    if got != want:
        raise ConfigError(f"{c['name']}: {c['cfg']} is not the network the "
                          f"configuration states: it has {got}, the file "
                          f"states {want}")
    c["cfg_path"] = cfg_path
    return c, net


def make_weights(net, seed: int, device) -> list:
    """Per layer None or the conv's float params (darknet's: HWIO weights,
    biases, batch norm unfused) as float32 tensors on ``device``, from one
    uniform draw; the heads sparse with objectness bias 0."""
    parts = []
    for l in net.convs:
        for k, shape in net.ref.conv_param_shapes(l).items():
            parts.append((l, k, shape, int(np.prod(shape))))
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(sum(p[3] for p in parts), generator=g, device=device)
    lo_hi = {"biases": (-0.5 * SHIFT, 0.5 * SHIFT), "scales": (0.5, 1.5),
             "rolling_mean": (-0.3 * SHIFT, 0.3 * SHIFT),
             "rolling_variance": (0.2, 1.5)}
    out = [None] * len(net.layers)
    at = 0
    for l, k, shape, n in parts:
        v = u[at:at + n].view(shape)
        at += n
        if k == "weights":
            s = float(np.sqrt(2.0 / (l.size * l.size * l.c)))
            v = (v * 2 - 1) * s
        else:
            lo, hi = lo_hi[k]
            v = v * (hi - lo) + lo
        out[l.index] = out[l.index] or {}
        out[l.index][k] = v
    return sparse_heads(net, out)


def sparse_heads(net, params: list) -> list:
    """Each head conv's box channels (``head_channels``), weights and
    biases, damped by :data:`HEAD_DAMP`; its anchors' objectness biases at
    0."""
    ref = net.ref
    for h in net.heads:
        conv = net.layers[h.index - 1]
        if conv.kind != "conv":
            continue
        p = params[conv.index]
        damp = torch.ones(h.c, device=p["weights"].device)
        for box, _ in ref.head_channels(h):
            damp[box] = HEAD_DAMP
        p["weights"] = p["weights"] * damp
        p["biases"] = p["biases"] * damp
    return set_obj_bias(net, params, 0.0)


def set_obj_bias(net, params: list, obj_bias: float) -> list:
    """Every head's anchors' objectness biases set to ``obj_bias``."""
    ref = net.ref
    for h in net.heads:
        b = params[h.index - 1]["biases"]
        for _, obj in ref.head_channels(h):
            b[obj] = obj_bias
    return params


def calibrate_obj_bias(net, params: list, frames, arith: str,
                       thresh: float, target: int, device) -> float:
    """chip_smoke.calibrate_obj_bias on the reference: the objectness bias
    that leaves about ``target`` candidates a frame of ``frames`` (uint8
    ``[F, H, W, C]``) above ``thresh``. One forward with the bias at 0 gives
    each candidate's objectness logit and best class probability
    (``objectness_and_best``); a bisection on the bias counts the
    candidates the decode keeps (objectness above the threshold and
    objectness times the best class above it). Taken over several frames,
    so that every seed's pool holds about as many candidates as any
    other's."""
    ref = net.ref
    prep = ref.prepare(net, params, arith, device)
    with torch.inference_mode():
        x = ref.ingest(torch.from_numpy(frames).to(device), net.w, net.h)
        z, best = ref.objectness_and_best(
            net, ref.forward(net, prep, x, arith, logits=True))
    del prep

    def live(bias):
        obj = 1 / (1 + np.exp(-(z + bias)))
        return ((obj * best > thresh) & (obj > thresh)).sum() / len(frames)

    lo, hi = -60.0, 60.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if live(mid) < target else (lo, mid)
    return float(np.float32(hi))


def host_params(net, params: list) -> list:
    """The float params as the program's host chain takes them: per layer
    None or a dict of float32 NumPy arrays."""
    return [None if p is None else
            {k: v.detach().cpu().numpy().astype(np.float32)
             for k, v in p.items()} for p in params]


def build_program(config: dict, traffic: dict, host: list, device):
    """The system under test: the port's init chain (cfg parse, batch-norm
    fuse, binarize, int8 quantize) and its ``DetectionPipeline`` with the
    traffic's threshold, NMS and candidate buffer. The program block is
    passed on, its ``compute_dtype`` as a torch type; the pipeline's
    defaults stand for what it leaves out."""
    from yolo2_light_tpu_torch.cfg import parse_network_cfg
    from yolo2_light_tpu_torch.pipeline import DetectionPipeline
    from yolo2_light_tpu_torch.quant import quantize_params
    from yolo2_light_tpu_torch.weights import fuse_conv_batchnorm
    from yolo2_light_tpu_torch.xnor import binarize_params

    run = dict(config["program"])
    mode = run.pop("mode")
    if "compute_dtype" in run:
        run["compute_dtype"] = getattr(torch, run["compute_dtype"])
    quantized = mode == "int8"
    spec = parse_network_cfg(config["cfg_path"], batch=1, quantized=quantized,
                             echo_table=False)
    params = binarize_params(spec, fuse_conv_batchnorm(spec, host))
    if quantized:
        params = quantize_params(spec, params)
    return DetectionPipeline(
        spec, params, mode, thresh=traffic["thresh"],
        nms=nms_of(config, traffic), k=traffic["k"],
        device_nms=traffic["device_nms"], device=device, **run)


def nms_of(config: dict, traffic: dict) -> float:
    """The traffic's NMS threshold for the configuration's mode (the demo
    takes 0.2 under -quantized, 0.4 otherwise)."""
    return traffic.get("nms_" + config["program"]["mode"], traffic["nms"])


def prebuild(config: dict, traffic: dict) -> None:
    """Build the hand kernels the cell's program launches, in parallel (a
    warm checkout finds them built)."""
    from concurrent.futures import ThreadPoolExecutor

    from yolo2_light_tpu_torch.ops import _build
    names = list(config["kernels"])
    if traffic["device_nms"]:
        names += ["nms_order", "nms_walk"]
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
