"""Network forward: ModelSpec -> ``forward(params, x)`` in PyTorch.

Counterpart of ``yolo2_light_tpu/models/network.py``. PyTorch runs eagerly,
so the forward is a Python loop over the static spec that calls one op per
layer; the int8 convs launch the hand-written kernel of ``ops/int8_conv``.

Ported modes:

* ``fp32``: dense convs in full float32 (TF32 off);
* ``int8`` with ``int8_policy="cpu"``: every conv except index 0 and the
  LINEAR-activation convs runs the int8 path (reference dispatch:
  src/yolov2_forward_network_quantized.c:1036-1037). The input of each int8
  conv is quantized where the conv reads it (consumer side); the JAX
  package's producer-side chaining gives bit-identical values.
  ``int8_impl="fused"`` runs each darknet53 residual block (1x1 conv, 3x3
  conv, shortcut) as one launch of the kernel of ``ops/fused_res`` and the
  other int8 convs on ``ops/int8_conv``: bit-identical to the unfused path.
* XNOR convs (``xnor=1``, outside the int8 set) in either mode, on the engine
  ``xnor_impl`` names: ``int8`` the dense +-1 conv (``layers.conv2d_xnor``),
  ``pallas`` the popcount kernel and ``pallas_mxu`` the bit-packed int8
  kernel of ``ops/xnor_gemm`` (both only where stride == 1 and pad == 1, the
  reference's bit path; every other XNOR conv takes the dense engine), and
  ``auto`` a per-layer pick between ``pallas_mxu`` and ``int8`` on the GEMM
  M = batch*oh*ow. All engines are bit-identical.

Everything else the JAX package's ``build_forward`` offers raises
``NotImplementedError`` naming what is not yet ported; nothing falls back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..cfg import (ConvSpec, MaxpoolSpec, ModelSpec, RegionSpec, ReorgSpec,
                   RouteSpec, ShortcutSpec, SoftmaxSpec, UpsampleSpec,
                   YoloSpec)
from ..ops import fused_res, int8_conv, xnor_gemm
from ..params import params_to_torch
from . import layers as L

# "xla", "pallas" and "fused" name the JAX package's engines; on the port
# "xla" and "pallas" run the int8 conv kernel behind every int8 conv, and
# "fused" runs the residual blocks on the fused kernel and the other int8
# convs on the int8 conv kernel. "plain" runs every kernel's plain PyTorch
# version instead (the int8 ones and the XNOR engine's), on any device: the
# reference the kernel paths are checked against.
INT8_IMPLS = ("xla", "pallas", "fused", "plain")
XNOR_IMPLS = ("int8", "pallas", "pallas_mxu", "auto")


class HeadOutput(NamedTuple):
    """Post-activation output of a detection head, cell-major.

    ``data``: [B, H, W, n, entries] where entries = 4 coords + 1 obj + classes.
    """
    index: int
    kind: str          # "yolo" | "region"
    data: torch.Tensor


def _int8_layer_set(spec: ModelSpec, policy: str) -> set:
    """Indices of the convs that run the int8 path under ``policy``."""
    out = set()
    for l in spec.layers:
        if not isinstance(l, ConvSpec):
            continue
        if policy == "cpu":
            if l.index >= 1 and l.activation != "linear":
                out.add(l.index)
        elif policy == "gpu":
            if l.quantized:
                out.add(l.index)
        else:
            raise ValueError(f"unknown int8 policy {policy!r}")
    return out


def _consumers(spec: ModelSpec) -> dict:
    """layer index -> indices of layers reading its output (routes read their
    sources; shortcuts read from_index and the preceding layer; every other
    non-first layer reads its predecessor)."""
    consumers: dict[int, list] = {i: [] for i in range(spec.n)}
    for l in spec.layers:
        if isinstance(l, RouteSpec):
            for j in l.layers:
                consumers[j].append(l.index)
        elif isinstance(l, ShortcutSpec):
            consumers[l.from_index].append(l.index)
            consumers[l.index - 1].append(l.index)
        elif l.index > 0:
            consumers[l.index - 1].append(l.index)
    return consumers


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to "
                               "yolo2_light_tpu_torch")


def _check_ported(spec: ModelSpec, mode: str, int8_policy: str,
                  int8_impl: str, xnor_impl: str, compute_dtype,
                  turbo) -> set:
    """Raise on anything this port does not run yet; returns the int8 set."""
    if mode not in ("fp32", "int8"):
        raise ValueError(f"unknown mode {mode!r} (expected fp32 or int8)")
    if int8_impl not in INT8_IMPLS:
        raise ValueError(f"unknown int8_impl {int8_impl!r} "
                         f"(expected one of {', '.join(INT8_IMPLS)})")
    if xnor_impl not in XNOR_IMPLS:
        raise ValueError(f"unknown xnor_impl {xnor_impl!r} "
                         "(expected int8, pallas, pallas_mxu, or auto)")
    if int8_policy not in ("cpu", "gpu", "cpu_old"):
        raise ValueError(f"unknown int8 policy {int8_policy!r}")
    if mode == "int8" and int8_policy != "cpu":
        raise _not_ported(f"-int8_policy {int8_policy}")
    if compute_dtype != torch.float32:
        raise _not_ported(f"compute dtype {compute_dtype} (-bf16)")
    if turbo:
        raise _not_ported("-turbo / -turbo_int8")
    int8_set = _int8_layer_set(spec, int8_policy) if mode == "int8" else set()
    for l in spec.layers:
        if isinstance(l, SoftmaxSpec):
            raise _not_ported(f"[softmax] layer {l.index}")
        if isinstance(l, RegionSpec) and l.softmax_tree is not None:
            raise _not_ported(f"region softmax tree (layer {l.index})")
    return int8_set


def _fused_stage_runs(spec: ModelSpec, int8_set: set) -> dict:
    """Maximal runs of darknet53 residual blocks

        conv1x1(leaky, int8) -> conv3x3(leaky, int8) -> shortcut(linear, from=-3)

    whose interior outputs feed nothing outside the run, as
    {start_conv_index: [(i_conv1, i_conv2, i_shortcut), ...]}: the JAX
    package's ``_fused_stage_runs`` without its two TPU-only limits. It
    splits runs to fit a VMEM budget and drops trunks whose C is not a
    multiple of 128 (DMA lane tiling); on the card every block is one launch
    whatever the run's length or width, so a run is only a grouping, and
    every matching block fuses."""
    consumers = _consumers(spec)

    def block_at(i):
        """(i, i+1, i+2) is a fusible residual block starting at conv i."""
        if i + 2 >= spec.n:
            return None
        l1, l2, ls = spec.layers[i], spec.layers[i + 1], spec.layers[i + 2]
        if not (isinstance(l1, ConvSpec) and l1.size == 1 and l1.stride == 1
                and l1.pad == 0 and l1.activation == "leaky" and i in int8_set
                and not l1.xnor):
            return None
        if not (isinstance(l2, ConvSpec) and l2.size == 3 and l2.stride == 1
                and l2.pad == 1 and l2.activation == "leaky"
                and (i + 1) in int8_set and not l2.xnor
                and l2.n == l1.c):   # 3x3 output must match the trunk width
            return None
        if not (isinstance(ls, ShortcutSpec) and ls.from_index == i - 1
                and ls.activation == "linear"):
            return None
        # interior conv outputs must feed only the block itself
        if consumers[i] != [i + 1] or consumers[i + 1] != [i + 2]:
            return None
        return (i, i + 1, i + 2)

    runs: dict[int, list] = {}
    i = 1
    while i + 2 < spec.n:
        blk = block_at(i)
        if blk is None:
            i += 1
            continue
        run = [blk]
        # extend: the previous shortcut's output may feed only the next block
        while True:
            e = run[-1][2]
            nxt = block_at(e + 1)
            if nxt is None or sorted(consumers[e]) != [e + 1, e + 3]:
                break
            run.append(nxt)
        runs[run[0][0]] = run
        i = run[-1][2] + 1
    return runs


def _bit_path(l: ConvSpec) -> bool:
    """The reference takes its XNOR bit path (0-bit, i.e. -1, borders) only
    at stride 1 and pad 1; the bit engines run only there."""
    return l.stride == 1 and l.pad == 1


def _xnor_engine(l: ConvSpec, xnor_impl: str, batch: int) -> str:
    """The engine XNOR conv ``l`` runs at ``batch``: "int8" (the dense +-1
    conv), "pallas" (K3) or "pallas_mxu" (K4). All are bit-identical, so
    "auto" is a speed pick on the GEMM M = batch*oh*ow: the bit-packed
    kernel where M is small, the dense conv above
    (``ops/xnor_gemm.auto_prefers_mxu``)."""
    if xnor_impl == "auto":
        xnor_impl = ("pallas_mxu" if xnor_gemm.auto_prefers_mxu(
            batch * l.out_h * l.out_w) else "int8")
    return xnor_impl if _bit_path(l) else "int8"


def _dropped_fields(l, int8_set: set, xnor_impl: str) -> frozenset:
    """Converted params a layer's path does not read: an int8 conv keeps its
    int8 weights (and ignores xnor=1), a float conv its float weights, an
    XNOR conv the weights of the engines ``xnor_impl`` may give it."""
    xnor_fields = {"sign_weights", "packed_weights", "mean_arr"}
    if l.index in int8_set:
        return frozenset({"weights"} | xnor_fields)
    if not (isinstance(l, ConvSpec) and l.xnor):
        return frozenset({"weights_int8"})
    keep = {"mean_arr"}
    if xnor_impl in ("int8", "auto") or not _bit_path(l):
        keep.add("sign_weights")
    if xnor_impl != "int8" and _bit_path(l):
        keep.add("packed_weights")
    return frozenset({"weights", "weights_int8"} | (xnor_fields - keep))


def _block_args(p1: dict, p2: dict) -> dict:
    """One residual block's convs' params as ``fused_res_block`` arguments."""
    return dict(w1=p1["weights_int8"], b1=p1["biases"],
                m1=p1["input_quant_multipler"], alpha1=p1["alpha"],
                w2=p2["weights_int8"], b2=p2["biases"],
                m2=p2["input_quant_multipler"], alpha2=p2["alpha"])


def build_forward(spec: ModelSpec, mode: str = "fp32", *,
                  int8_policy: str = "cpu", int8_impl: str = "xla",
                  xnor_impl: str = "int8", compute_dtype=torch.float32,
                  turbo=False):
    """Return ``forward(params, x) -> (heads, aux)``.

    ``x``: [B, H, W, C] float32, NHWC, values in [0,1]. ``params``: the
    per-layer list of ``params.params_to_torch``. ``heads`` is a tuple of
    HeadOutput; ``aux["final"]`` is the last layer's output.
    """
    int8_set = _check_ported(spec, mode, int8_policy, int8_impl, xnor_impl,
                             compute_dtype, turbo)
    plain = int8_impl == "plain"
    # the fused kernel implements the cpu requant only (the gpu policy is
    # refused above, and would keep its own convs)
    fused_runs = (_fused_stage_runs(spec, int8_set)
                  if mode == "int8" and int8_impl == "fused"
                  and int8_policy == "cpu" else {})
    fused_skip = {idx for run in fused_runs.values()
                  for blk in run for idx in blk} - set(fused_runs)
    # outputs a route or a shortcut reads; every other one is dropped once
    # the next layer has consumed it
    kept = {j for j, readers in _consumers(spec).items()
            if any(isinstance(spec.layers[c], (RouteSpec, ShortcutSpec))
                   for c in readers)}
    L.set_fp32_precision()

    def forward(params, x):
        outputs: dict[int, torch.Tensor] = {}
        heads: list[HeadOutput] = []
        cur = x
        for l in spec.layers:
            i = l.index
            if i in fused_runs:
                run = fused_runs[i]
                blocks = [_block_args(params[i1], params[i2])
                          for i1, i2, _ in run]
                cur = fused_res.run_blocks(cur.contiguous(), blocks)
                # the run's interior outputs feed nothing outside it
                outputs[run[-1][2]] = cur
                continue
            if i in fused_skip:
                continue
            if isinstance(l, ConvSpec):
                p = params[i]
                # an int8-eligible conv runs the int8 path even with xnor=1,
                # as the reference's quantized forwards have no xnor branch
                if l.xnor and i not in int8_set:
                    engine = _xnor_engine(l, xnor_impl, cur.shape[0])
                    if engine == "int8":
                        cur = L.conv2d_xnor(cur, p["sign_weights"],
                                            p["mean_arr"], p["biases"],
                                            l.stride, l.pad, l.activation)
                    else:
                        cur = xnor_gemm.conv2d_xnor_bits(
                            cur, p["packed_weights"], p["mean_arr"],
                            p["biases"], c_real=l.c, stride=l.stride,
                            pad=l.pad, activation=l.activation,
                            engine=("mxu" if engine == "pallas_mxu"
                                    else "popcount"), plain=plain)
                elif i in int8_set:
                    cur = L.conv2d_int8(
                        cur, p["weights_int8"], p["biases"], l.stride, l.pad,
                        l.activation, p["input_quant_multipler"], p["alpha"],
                        plain=plain)
                else:
                    bn = None
                    if "scales" in p:
                        bn = (p["scales"], p["rolling_mean"],
                              p["rolling_variance"])
                    cur = L.conv2d_fp32(cur, p["weights"], p["biases"],
                                        l.stride, l.pad, l.activation, bn=bn)
            elif isinstance(l, MaxpoolSpec):
                cur = L.maxpool(cur, l.size, l.stride, l.pad, l.out_w, l.out_h)
            elif isinstance(l, RouteSpec):
                cur = L.route([outputs[j] for j in l.layers])
            elif isinstance(l, ReorgSpec):
                cur = L.reorg(cur, l.stride, l.reverse)
            elif isinstance(l, UpsampleSpec):
                cur = L.upsample(cur, l.stride, l.scale)
            elif isinstance(l, ShortcutSpec):
                cur = L.shortcut(cur, outputs[l.from_index], l.activation)
            elif isinstance(l, YoloSpec):
                b, h, w, _ = cur.shape
                cur = L.yolo_head(cur, l.n, l.classes)
                heads.append(HeadOutput(
                    i, "yolo", cur.reshape(b, h, w, l.n, 5 + l.classes)))
            elif isinstance(l, RegionSpec):
                y5 = L.region_head(cur, l.n, l.classes, l.coords, l.softmax)
                b, h, w = y5.shape[:3]
                cur = y5.reshape(b, h, w, -1)
                heads.append(HeadOutput(i, "region", y5))
            else:
                raise _not_ported(f"layer {type(l).__name__}")
            if i in kept:
                outputs[i] = cur
        return tuple(heads), {"final": cur}

    return forward


def device_params(spec: ModelSpec, params: list, mode: str, device, *,
                  int8_policy: str = "cpu", xnor_impl: str = "int8") -> list:
    """``params`` on ``device`` through ``params.params_to_torch``, each conv
    keeping only the weights of the path it runs: in int8 mode the int8
    convs their int8 weights, an XNOR conv those of its engines."""
    int8_set = _int8_layer_set(spec, int8_policy) if mode == "int8" else ()
    drops = [_dropped_fields(l, int8_set, xnor_impl) for l in spec.layers]
    return params_to_torch(params, device, drops)


def load_kernels(spec: ModelSpec, mode: str, *, int8_policy: str = "cpu",
                 int8_impl: str = "xla", xnor_impl: str = "int8") -> None:
    """Build and bind the hand kernels a forward of ``spec`` launches on the
    card, so that the first forward does not include their builds."""
    if int8_impl == "plain":
        return
    int8_set = _int8_layer_set(spec, int8_policy) if mode == "int8" else ()
    if mode == "int8":
        int8_conv.load_kernel()
        if int8_impl == "fused":
            fused_res.load_kernel()
    if any(isinstance(l, ConvSpec) and l.xnor and _bit_path(l)
           and l.index not in int8_set for l in spec.layers):
        if xnor_impl == "pallas":
            xnor_gemm.load_kernel("xnor_gemm")
        elif xnor_impl in ("pallas_mxu", "auto"):
            xnor_gemm.load_kernel("xnor_gemm_mxu")


class Predictor(nn.Module):
    """One call, image(s) in, head maps out, on one explicit device.

    The converted params are the module's buffers (``l<index>_<name>``); the
    int8 scalars (input multiplier, alpha) are plain floats. Each conv keeps
    only the weights of the path it runs: in int8 mode the int8 convs their
    int8 weights, an XNOR conv those of its engines. On a CUDA device the
    kernels are built here, so the first forward does not include the build.
    """

    def __init__(self, spec: ModelSpec, params: list, mode: str = "fp32", *,
                 device="cuda", int8_policy: str = "cpu",
                 int8_impl: str = "xla", xnor_impl: str = "int8",
                 compute_dtype=torch.float32, turbo=False):
        super().__init__()
        self.spec = spec
        self.mode = mode
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (use device='cpu' to "
                               "run the plain PyTorch path)")
        self._forward = build_forward(spec, mode, int8_policy=int8_policy,
                                      int8_impl=int8_impl, xnor_impl=xnor_impl,
                                      compute_dtype=compute_dtype, turbo=turbo)
        self._layout: list = []   # per layer: None or (tensor names, scalars)
        for i, p in enumerate(device_params(spec, params, mode, self.device,
                                            int8_policy=int8_policy,
                                            xnor_impl=xnor_impl)):
            if p is None:
                self._layout.append(None)
                continue
            names, scalars = [], {}
            for k, v in p.items():
                if isinstance(v, torch.Tensor):
                    self.register_buffer(f"l{i}_{k}", v)
                    names.append(k)
                else:
                    scalars[k] = v
            self._layout.append((names, scalars))
        if self.device.type == "cuda":
            load_kernels(spec, mode, int8_policy=int8_policy,
                         int8_impl=int8_impl, xnor_impl=xnor_impl)

    def layer_params(self) -> list:
        """The per-layer param dicts ``forward`` reads, from the buffers."""
        out = []
        for i, entry in enumerate(self._layout):
            if entry is None:
                out.append(None)
                continue
            names, scalars = entry
            d = dict(scalars)
            for k in names:
                d[k] = getattr(self, f"l{i}_{k}")
            out.append(d)
        return out

    def forward(self, x) -> tuple:
        x = torch.as_tensor(x).to(self.device, torch.float32)
        # dense NHWC strides: a batch of one whose batch stride is 0 (NumPy's
        # ``im[None]``) does not read as channels-last to cuDNN, which then
        # runs the first conv in NCHW, and the int8 conv after it would have
        # to copy its input dense
        x = x.reshape(-1).view(x.shape)
        with torch.inference_mode():
            heads, _ = self._forward(self.layer_params(), x)
        return heads

    def head_specs(self):
        return [l for l in self.spec.layers
                if isinstance(l, (YoloSpec, RegionSpec))]
