"""The plain reference of a darknet YOLO network, in PyTorch.

Independent of the program under test: it parses the cfg itself
(``cfg.py``), takes the float weights as darknet stores them (HWIO, batch
norm unfused) and works out again everything a deployment derives from
them: the batch-norm fuse, the int8 weights and the multipliers of
yolo2_light's ``-quantized`` mode. Every op is a plain ``torch`` op, one at
a time, in float32 unless said otherwise.

Arithmetics (``arith``):

* ``int8``: yolo2_light's ``-quantized`` forward with the CPU semantics
  (src/yolov2_forward_network_quantized.c, forward_convolutional_layer_q):
  every conv but the first and the linear ones quantizes its input to
  ``clamp(trunc(x * input_mult), +-127)``, sums int8 products exactly,
  requantizes ``clamp(trunc(acc / 32), +-32767)``, scales by
  ``32 / (input_mult * weights_mult)``, adds the bias and applies the
  leaky ``x > 0 ? x : x / 10``. The other convs run in float32.
* ``bf16``: every conv takes its input and its fused weights rounded to
  bfloat16 and sums in float32; bias and leaky (``0.1 * x``) in float32.
* ``f32``: every conv in float32.
* The controls, one step below each: ``int4`` (the int8 path at 4 bits:
  ``clamp(trunc(x * m / 16), +-7)`` for inputs and weights, the sum
  scaled back) and ``fp8`` (the bf16 path with float8 e4m3 operands,
  each tensor scaled by 448 over its largest magnitude, per image for
  activations).

Exact integer sums are taken as float64 convolutions with cuDNN off (its
FFT and Winograd algorithms round even in float64); float32 convolutions
run with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cfg import Net

R_MULT = 32
W_MAX = 127
I_MAX = 127
DEFAULT_INPUT_MULT = 40.0
FP8_MAX = 448.0
ARITHS = ("f32", "int8", "bf16", "int4", "fp8")


def set_float32_exact() -> None:
    """float32 convolutions and matmuls without TF32, deterministic."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def integer_layers(net: Net) -> set:
    """The convs yolo2_light's quantized forward runs in integers: all but
    the first and those with a linear activation."""
    return {l.index for l in net.convs
            if l.index >= 1 and l.activation != "linear"}


def fuse_bn(p: dict) -> tuple:
    """(weights HWIO, biases) with batch norm folded in, in float32
    (yolov2_fuse_conv_batchnorm: ``denom = sqrt(var) + 1e-6`` outside the
    root)."""
    w, b = p["weights"].float(), p["biases"].float()
    if "scales" not in p:
        return w, b
    denom = torch.sqrt(p["rolling_variance"].float()) + 1e-6
    factor = p["scales"].float() / denom
    b = b - p["scales"].float() * p["rolling_mean"].float() / denom
    return w * factor, b


def weights_multiplier(w: torch.Tensor) -> float:
    """yolo2_light's get_multiplier(w, 8) / 4: the histogram of the positive
    values over doubling ranges [2^(j-16), 2^(j-15)), j < 32, the window of
    8 ranges holding the most (the first such), its lowest range's
    reciprocal, over 4."""
    pos = w[w >= 2.0 ** -16].double()
    _, e = torch.frexp(pos)                 # pos = m * 2^e, m in [0.5, 1)
    j = (e - 1 + 16).long()
    j = j[j < 32]
    counts = torch.bincount(j, minlength=32)[:32].tolist()
    best, best_j = 0, 0
    for s in range(32):
        window = sum(counts[s:s + 8])
        if best < window:
            best, best_j = window, s
    return float(np.float32(2.0 ** (16 - best_j) / 4.0))


def _f32(v: float) -> float:
    return float(np.float32(v))


def prepare(net: Net, raw: list, arith: str, device) -> list:
    """Per layer: None, or the conv's tensors on ``device`` in the layout
    the forward reads (OIHW) and its scalars, for ``arith``."""
    if arith not in ARITHS:
        raise ValueError(f"unknown arithmetic {arith!r}")
    ints = integer_layers(net) if arith in ("int8", "int4") else set()
    calib = net.input_calibration
    out = [None] * len(net.layers)
    counter = 0
    for l in net.convs:
        p = {k: v.to(device) for k, v in raw[l.index].items()}
        w, b = fuse_bn(p)
        in_mult = calib[counter] if counter < len(calib) else DEFAULT_INPUT_MULT
        counter += 1
        q = {"bias": b, "int": l.index in ints}
        if q["int"]:
            wm = weights_multiplier(w)
            if arith == "int8":
                wq = torch.clamp(torch.trunc(w * wm), -W_MAX, W_MAX)
                q["in_mult"] = _f32(in_mult)
                q["alpha"] = _f32(np.float32(R_MULT) / (np.float32(in_mult)
                                                       * np.float32(wm)))
            else:
                wq = torch.clamp(torch.trunc(w * (wm / 16)), -7, 7)
                q["in_mult"] = _f32(in_mult / 16)
                q["alpha"] = _f32(1.0 / ((in_mult / 16) * (wm / 16)))
            q["w"] = wq.permute(3, 2, 0, 1).contiguous().double()
        elif arith == "bf16":
            q["w"] = w.to(torch.bfloat16).float().permute(3, 2, 0, 1) \
                .contiguous()
        elif arith == "fp8":
            q["w"] = _fp8(w, w.abs().max()).permute(3, 2, 0, 1).contiguous()
        else:
            q["w"] = w.permute(3, 2, 0, 1).contiguous()
        out[l.index] = q
    return out


def _fp8(x: torch.Tensor, amax) -> torch.Tensor:
    """``x`` through float8 e4m3 at the scale ``448 / amax``."""
    s = FP8_MAX / torch.clamp(torch.as_tensor(amax, dtype=torch.float32,
                                              device=x.device), min=1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


def _leaky_tenth(y):
    return torch.where(y > 0, y, y * 0.1)


def _conv(l, q, x: torch.Tensor, arith: str) -> torch.Tensor:
    """One conv of the NHWC float32 map ``x``."""
    if q["int"]:
        top = I_MAX if arith == "int8" else 7
        xq = torch.clamp(torch.trunc(x * q["in_mult"]), -top, top)
        with torch.backends.cudnn.flags(enabled=False):
            acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), q["w"],
                           stride=l.stride, padding=l.pad)
        acc = acc.permute(0, 2, 3, 1)
        if arith == "int8":
            # C integer division truncates toward zero
            acc = torch.clamp(torch.trunc(acc / R_MULT), -32767, 32767)
        y = acc.float() * q["alpha"] + q["bias"]
        if l.activation == "leaky":
            ten = torch.full((), 10.0, device=y.device)
            y = torch.where(y > 0, y, y / ten)
        return y
    if arith == "bf16":
        xin = x.to(torch.bfloat16).float()
    elif arith == "fp8":
        amax = x.abs().flatten(1).amax(1)[:, None, None, None]
        xin = _fp8(x, amax)
    else:
        xin = x
    y = F.conv2d(xin.contiguous().permute(0, 3, 1, 2), q["w"],
                 stride=l.stride, padding=l.pad).permute(0, 2, 3, 1)
    y = y + q["bias"]
    if l.activation == "leaky":
        return _leaky_tenth(y)
    if l.activation != "linear":
        raise ValueError(f"conv {l.index}: activation {l.activation!r}")
    return y


def _maxpool(l, x: torch.Tensor) -> torch.Tensor:
    """Darknet maxpool: window origin at ``-pad // 2``, positions outside
    the map read as minus infinity."""
    lo = l.pad // 2
    need_h = (l.out_h - 1) * l.stride + l.size
    need_w = (l.out_w - 1) * l.stride + l.size
    xp = F.pad(x.permute(0, 3, 1, 2),
               (lo, max(0, need_w - lo - l.w), lo, max(0, need_h - lo - l.h)),
               value=float("-inf"))
    y = F.max_pool2d(xp, l.size, l.stride)[:, :, :l.out_h, :l.out_w]
    return y.permute(0, 2, 3, 1)


def forward(net: Net, prep: list, x: torch.Tensor, arith: str,
            logits: bool = False) -> list:
    """NHWC float32 images in [0, 1] at the net's size -> the heads, each
    ``[B, H, W, n, 5 + classes]`` with x, y, objectness and classes through
    the logistic (darknet's forward_yolo_layer), or before it where
    ``logits``."""
    set_float32_exact()
    outs = {}
    read = {s for l in net.layers for s in l.sources}
    heads = []
    cur = x
    for l in net.layers:
        if l.kind == "conv":
            cur = _conv(l, prep[l.index], cur, arith)
        elif l.kind == "maxpool":
            cur = _maxpool(l, cur)
        elif l.kind == "shortcut":
            cur = cur + outs[l.sources[0]]
            if l.activation != "linear":
                raise ValueError(f"shortcut {l.index}: {l.activation!r}")
        elif l.kind == "route":
            cur = torch.cat([outs[j] for j in l.sources], dim=-1)
        elif l.kind == "upsample":
            cur = cur.repeat_interleave(l.stride, 1) \
                .repeat_interleave(l.stride, 2)
        elif l.kind == "yolo":
            y = cur.reshape(cur.shape[0], l.h, l.w, l.n, 5 + l.classes)
            heads.append(y if logits else torch.cat(
                [torch.sigmoid(y[..., 0:2]), y[..., 2:4],
                 torch.sigmoid(y[..., 4:])], dim=-1))
        if l.index in read:
            outs[l.index] = cur
    return heads
