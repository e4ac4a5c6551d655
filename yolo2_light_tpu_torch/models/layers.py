"""Darknet layer ops in PyTorch, NHWC at every public function.

Counterpart of ``yolo2_light_tpu/models/layers.py``; each function keeps the
JAX function's name, arguments and semantics, with the reference's source
cited there. Tensors are ``[B, H, W, C]`` like the JAX package's, so the
tests compare like with like; convolutions run on a permuted NCHW view that
is channels-last in memory. Conv weights are laid out once at load time by
``params.params_to_torch``: fp32 weights as PyTorch's ``[O, I, kh, kw]``,
int8 weights as the kernel's ``[M, kh, kw, C]``, XNOR +-1 weights as
float32 ``[O, I, kh, kw]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import bf16_conv, int8_conv

# ---------------------------------------------------------------------------
# Activations (reference: src/additionally.h:66-165)
# ---------------------------------------------------------------------------


def _stair(x):
    n = torch.floor(x)
    even = torch.remainder(n, 2) == 0
    return torch.where(even, torch.floor(x / 2.0),
                       (x - n) + torch.floor(x / 2.0))


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946

ACTIVATION_FNS = {
    "linear": lambda x: x,
    "logistic": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "loggy": lambda x: 2.0 / (1.0 + torch.exp(-x)) - 1.0,
    "relu": lambda x: x * (x > 0),
    "elu": lambda x: torch.where(x >= 0, x, torch.exp(x) - 1.0),
    "selu": lambda x: torch.where(x >= 0, _SELU_SCALE * x,
                                  _SELU_SCALE * _SELU_ALPHA
                                  * (torch.exp(x) - 1.0)),
    "relie": lambda x: torch.where(x > 0, x, 0.01 * x),
    "ramp": lambda x: x * (x > 0) + 0.1 * x,
    "leaky": lambda x: torch.where(x > 0, x, 0.1 * x),
    "tanh": lambda x: (torch.exp(2 * x) - 1.0) / (torch.exp(2 * x) + 1.0),
    "plse": lambda x: torch.where(
        x < -4, 0.01 * (x + 4),
        torch.where(x > 4, 0.01 * (x - 4) + 1.0, 0.125 * x + 0.5)),
    "stair": _stair,
    "hardtan": lambda x: torch.clamp(x, -1.0, 1.0),
    "lhtan": lambda x: torch.where(
        x < 0, 0.001 * x, torch.where(x > 1, 0.001 * (x - 1) + 1.0, x)),
    # x * tanh(softplus(x)) (AlexeyAB/darknet's activate_array_mish, whose
    # softplus threshold of 20 changes nothing in float32: see
    # ops/int8_conv.mish_plain)
    "mish": F.mish,
}


def activate(x: torch.Tensor, name: str) -> torch.Tensor:
    return ACTIVATION_FNS[name](x)


# ---------------------------------------------------------------------------
# Convolution (+ BN + bias + activation epilogue)
# ---------------------------------------------------------------------------


def set_fp32_precision() -> None:
    """Full float32, run-to-run reproducible convs and matmuls. CUDA's
    default lets cuDNN convs (and may let matmuls) run in TF32, which keeps
    about three decimal digits, where the JAX reference runs its fp32 convs
    at Precision.HIGHEST; and cuDNN may pick algorithms whose atomics sum in
    a different order on every run, so one ULP of drift could move an int8
    quantization bin or a printed detection between two runs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def conv2d_fp32(x, weights, biases, stride: int, pad: int, activation: str,
                bn=None, compute_dtype=torch.float32, plain: bool = False, *,
                weights_k32=None):
    """Dense conv + optional (unfused) BN + bias + activation.
    ``weights``: ``[O, I, kh, kw]`` (float32, or already in ``compute_dtype``).

    BN math (reference: src/yolov2_forward_network.c:222-239):
      y = (conv - rolling_mean) / (sqrt(rolling_variance) + 1e-6) * scales + bias
    with epsilon added OUTSIDE the sqrt. ``network.build_forward`` turns TF32 off
    (:func:`set_fp32_precision`) before any conv runs.

    ``compute_dtype=bfloat16`` (``-bf16``) convolves the input and the
    weights rounded to bfloat16 and sums in float32, as the JAX package does
    (``preferred_element_type=float32``); BN, bias and the activation run
    in float32. It is ``ops/bf16_conv.conv2d_bf16``: on a CUDA tensor one
    launch of the hand kernel, which rounds the float32 input as it stages
    it and, with BN folded into the weights (every app path), runs bias and
    leaky or linear in its store; on a CPU tensor (or with ``plain=True``,
    the reference the kernel is checked against) its plain twin, the
    float32 conv of the bfloat16-rounded operands, then the same chain as
    PyTorch ops (``bf16_conv.epilogue_plain``). The products are exact in
    float32, so either is XLA's result up to the order of the sums. An
    unfused BN runs as PyTorch ops after the bare conv, and any other
    activation follows as a PyTorch op. A bfloat16 input (turbo's maps) is
    upcast first, exactly. Weights laid out by ``params`` (bfloat16 in
    channels-last memory) reach the kernel without a copy;
    ``weights_k32``, the first conv's rows padded for the kernel, is made
    once there too.

    The float32 path makes the input dense NHWC first (a no-op for the
    kernels' outputs): cuDNN picks its algorithm by the memory layout too.
    """
    if compute_dtype == torch.bfloat16:
        xb = x.to(torch.float32).contiguous()
        wk = bf16_conv.kernel_weights(weights)
        if bn is None:
            y = bf16_conv.conv2d_bf16(xb, wk, stride, pad, w_k32=weights_k32,
                                      biases=biases, activation=activation,
                                      plain=plain)
            if activation in bf16_conv.STORE_ACTIVATIONS:
                return y
            return activate(y, activation)
        y = bf16_conv.conv2d_bf16(xb, wk, stride, pad, w_k32=weights_k32,
                                  plain=plain)
    else:
        xc = x.contiguous().permute(0, 3, 1, 2).to(compute_dtype)
        y = F.conv2d(xc, weights.to(compute_dtype), stride=stride,
                     padding=pad)
        y = y.permute(0, 2, 3, 1)
    if bn is not None:
        scales, rolling_mean, rolling_variance = bn
        denom = torch.sqrt(rolling_variance) + 1e-6
        y = (y - rolling_mean) / denom * scales
    y = y + biases
    return activate(y, activation)


# input quantization of the int8 path (ops/int8_conv counts its launches)
quantize_i8 = int8_conv.quantize_i8


def conv2d_int8(x, weights_int8, biases, stride: int, pad: int,
                activation: str, input_mult: float, alpha: float,
                r_mult: int = 32, plain: bool = False, *,
                semantics: str = "cpu", x_int8=None, out_dtype=None,
                out_mult: float | None = None):
    """INT8 conv path, in either of the reference's two flavors.

    ``semantics="cpu"`` (reference: forward_convolutional_layer_q,
    src/yolov2_forward_network_quantized.c:527-631):

      1. quantize input: int8 = clamp(trunc(x * input_mult), +-127)
      2. int8 conv, int32 accumulation over the full K
      3. requantize: q = clamp(trunc_div(acc, R_MULT), +-32767)
      4. y = q * alpha + bias, alpha = R_MULT / (input_mult * weights_mult)
      5. LEAKY is x>0 ? x : x/10 on this path (NOT 0.1*x)

    ``semantics="gpu"`` (reference: forward_convolutional_layer_gpu_cudnn_
    quantized, src/yolov2_forward_network_gpu.cu:143-315, the cuDNN INT8x4
    path): the same steps 1-2, then y = acc * alpha + bias with
    ``alpha`` = inv = 1 / (input_mult * weights_mult) (``params``' ``inv``),
    no requant, and the standard 0.1*y leaky.

    ``x`` may be float32 or bfloat16 (a bfloat16 map is upcast exactly
    before the quantize, as JAX promotes it against the float32
    multiplier). ``x_int8``: the producer's pre-quantized input (the int8
    chain); ``x`` is then not read. ``out_dtype``: None (float32), bfloat16
    (the turbo store) or int8 at ``out_mult`` (the int8 residual trunk's
    quantize).

    Each call is one launch of the int8 kernel (``ops/int8_conv``: its
    float- or int8-input entry, the epilogue and the store fused) for a
    CUDA tensor, where the activation is leaky or linear, or mish on a
    float32 input stored as float32 (``int8_conv.fuses``); ``plain=True``
    runs its plain PyTorch version instead (the reference the kernel is
    checked against). Any other activation, and mish beside another input
    or store, runs as a PyTorch op on the kernel's float32 linear result,
    then the store. ``weights_int8``: ``[M, kh, kw, C]``.
    """
    xin = x if x_int8 is None else x_int8
    fused = int8_conv.fuses(activation, xin.dtype, out_dtype, semantics)
    epilogue = activation if fused else "linear"
    store = dict(semantics=semantics,
                 out_dtype=out_dtype if fused and out_dtype else torch.float32,
                 out_mult=out_mult if fused else None)
    if not (plain or xin.is_contiguous()):
        # a conv output seen through its NHWC permute need not be
        # NHWC-dense; the kernel reads dense NHWC rows
        if xin.is_cuda:
            int8_conv.PRE_LAUNCHES["input_copy"] += 1
        xin = xin.contiguous()
    if x_int8 is not None:
        conv = int8_conv.conv2d_int8_plain if plain else int8_conv.conv2d_int8
        y = conv(xin, weights_int8, biases, alpha, stride, pad, epilogue,
                 r_mult, **store)
    else:
        conv = (int8_conv.conv2d_int8_f32_plain if plain
                else int8_conv.conv2d_int8_f32)
        y = conv(xin, weights_int8, biases, input_mult, alpha, stride, pad,
                 epilogue, r_mult, **store)
    if not fused:
        y = activate(y, activation)
        if out_dtype is not None:
            y = int8_conv.store_plain(y, out_dtype, out_mult)
    return y


def conv2d_int8_old(x_int8, weights_int8, biases_quant, output_multipler,
                    stride: int, pad: int, activation: str, r_mult: int = 32,
                    plain: bool = False, *, store=int8_conv.OLD_BOTH):
    """Legacy fully-INT8 conv (reference: forward_convolutional_layer_q_old,
    src/yolov2_forward_network_quantized.c:636-801, unreachable from its
    CLI), int8 in, int8 and/or float out:

      q1 = clamp(trunc_div(acc_int32, R_MULT), +-32767)
      q2 = trunc(q1 * output_multipler)
      q3 = trunc(q2 + biases_quant)
      q4 = leaky: q3 > 0 ? q3 : trunc(q3 / 10)
      returns (float_out = q4 / 16, int8_out = clamp(q4, +-127))

    ``store`` names the outputs to make: ``int8_conv.OLD_BOTH`` (both, the
    JAX function's pair), ``torch.float32`` or ``torch.int8``; an output
    left out is None in the returned pair. Each call is one launch of the
    int8 kernel's "old" epilogue (``ops/int8_conv``, both stores in one
    pass) for a CUDA tensor; ``plain=True`` runs its plain PyTorch version
    instead. ``weights_int8``: ``[M, kh, kw, C]``."""
    if activation not in ("leaky", "linear"):
        raise NotImplementedError(activation)
    if not (plain or x_int8.is_contiguous()):
        if x_int8.is_cuda:
            int8_conv.PRE_LAUNCHES["input_copy"] += 1
        x_int8 = x_int8.contiguous()
    conv = int8_conv.conv2d_int8_plain if plain else int8_conv.conv2d_int8
    y = conv(x_int8, weights_int8, biases_quant, output_multipler, stride,
             pad, activation, r_mult, semantics="old", out_dtype=store)
    if store == int8_conv.OLD_BOTH:
        return y
    return (y, None) if store == torch.float32 else (None, y)


def conv2d_xnor(x, sign_weights, mean_arr, biases, stride: int, pad: int,
                activation: str):
    """XNOR (BIT1) conv as a dense +-1 convolution, the ``-xnor_kernel int8``
    engine (reference: the popcount GEMM (2*popcount(xnor) - K) * mean,
    src/additionally.c:1185-1242, src/gpu.cu:1566-1741).
    ``sign_weights``: ``[O, I, kh, kw]`` float32 +-1; ``mean_arr``: the
    per-filter mean |w| factored out of the product.

    Input binarized to +-1 by (x > 0) (reference: binarize_cpu,
    src/additionally.c:128-135), float32 or bfloat16 alike; the output is
    float32 either way. Borders: the reference's bit path, taken
    when stride==1 and pad==1, writes 0 bits for the padding, which decode
    to -1 (im2col_cpu_custom_bin, src/additionally.c:883-1002); any other
    stride or pad runs the binarized float conv, whose im2col pads with 0.0.

    The +-1 products sum to integers below 2**24, exact in float32 in any
    order of addition; cuDNN is kept out, since its algorithm choice may
    include Winograd or FFT transforms, which round. The leaky slope is
    0.1*y here, not the int8 path's y/10.
    """
    xb = torch.where(x > 0, 1.0, -1.0).permute(0, 3, 1, 2)
    if stride == 1 and pad == 1:
        xb = F.pad(xb, (1, 1, 1, 1), value=-1.0)
        pad = 0
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xb, sign_weights, stride=stride, padding=pad)
    y = acc.permute(0, 2, 3, 1) * mean_arr + biases
    return activate(y, activation)


# ---------------------------------------------------------------------------
# Maxpool
# ---------------------------------------------------------------------------


def _maxpool_from(x, size: int, stride: int, lo: int, out_w: int,
                  out_h: int, fill: float):
    """Max over ``size`` x ``size`` windows of NHWC ``x`` whose origin is
    ``-lo``, out-of-bounds positions at ``fill``. An integer ``x`` pools in
    float32, which holds every int8 value exactly (PyTorch's max_pool2d
    takes no int8); a channels-last input gives a dense NHWC output."""
    h, w = x.shape[1], x.shape[2]
    hi_h = max(0, (out_h - 1) * stride + size - lo - h)
    hi_w = max(0, (out_w - 1) * stride + size - lo - w)
    y = x.permute(0, 3, 1, 2)
    if not x.is_floating_point():
        y = y.to(torch.float32)
    y = F.pad(y, (lo, hi_w, lo, hi_h), value=fill)
    y = F.max_pool2d(y, size, stride)
    return y.permute(0, 2, 3, 1)[:, :out_h, :out_w, :].to(x.dtype)


def maxpool(x, size: int, stride: int, pad: int, out_w: int, out_h: int):
    """Darknet maxpool: out = (in + pad - size)//stride + 1, window origin at
    ``-pad//2`` (reference: forward_maxpool_layer_avx, src/additionally.c:1041-1133:
    ``w_offset = -pad/2``). Padding is asymmetric: ``pad//2`` at the start and
    whatever the output extent needs at the end; out-of-bounds positions
    contribute -inf.

    An integer ``x`` (the int8 chain) pools with out-of-bounds positions at
    ``iinfo.min``, which never beats a real (>= -127) value: the exact
    commute with the float path."""
    integer = not x.is_floating_point()
    fill = float(torch.iinfo(x.dtype).min) if integer else float("-inf")
    return _maxpool_from(x, size, stride, pad // 2, out_w, out_h, fill)


def maxpool_int8_old(x_int8, size: int, stride: int, pad: int,
                     out_w: int, out_h: int):
    """Legacy int8 maxpool (reference: forward_maxpool_layer_q,
    src/yolov2_forward_network_quantized.c:806-849): window origin at
    ``-pad`` (NOT -pad/2 like the fp32 path, ROADMAP F4), out-of-bounds
    values are MIN_INT8 (-128)."""
    return _maxpool_from(x_int8, size, stride, pad, out_w, out_h, -128.0)


# ---------------------------------------------------------------------------
# Structural layers
# ---------------------------------------------------------------------------


def route(outputs: list) -> torch.Tensor:
    """Channel concat (reference memcpy-concat: src/yolov2_forward_network.c:318-334).
    Sources of different spatial dims concat as flat darknet-CHW vectors
    ``[B, sum(sizes)]``, as the reference's raw buffer copy does."""
    shapes = {(o.shape[1], o.shape[2]) for o in outputs}
    if len(shapes) != 1:
        return torch.cat([o.permute(0, 3, 1, 2).reshape(o.shape[0], -1)
                          for o in outputs], dim=1)
    return torch.cat(outputs, dim=-1)


def reorg(x, stride: int, reverse: bool = False):
    """Darknet reorg (reference: forward_reorg_layer_cpu,
    src/yolov2_forward_network.c:337-376), NHWC form of
    ``out[b, off*C + c, j, i] = x[b, c, j*s + off//s, i*s + off%s]``."""
    b, h, w, c = x.shape
    s = stride
    if not reverse:
        y = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, h // s, w // s, s * s * c)
    y = x.reshape(b, h, w, s, s, c // (s * s)).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h * s, w * s, c // (s * s))


def upsample(x, stride: int, scale: float = 1.0):
    """Nearest-neighbor upsample x stride, scaled (reference: upsample_cpu,
    src/yolov2_forward_network.c:380-396)."""
    y = x.repeat_interleave(stride, dim=1).repeat_interleave(stride, dim=2)
    if scale != 1.0:
        y = y * scale
    return y


def shortcut(x, from_out, activation: str):
    """Residual add (reference: shortcut_cpu + forward_shortcut_layer_cpu,
    src/yolov2_forward_network.c:410-450), general strided/sampled case
    included."""
    if x.shape == from_out.shape:
        y = x + from_out
    else:
        _, h2, w2, c2 = x.shape
        _, h1, w1, c1 = from_out.shape
        stride = max(1, w1 // w2)
        sample = max(1, w2 // w1)
        minw, minh, minc = min(w1, w2), min(h1, h2), min(c1, c2)
        add = from_out[:, : minh * stride: stride, : minw * stride: stride,
                       :minc]
        y = x.clone()
        y[:, : minh * sample: sample, : minw * sample: sample, :minc] += add
    return activate(y, activation)


# ---------------------------------------------------------------------------
# Detection heads
# ---------------------------------------------------------------------------


def yolo_head(x, n: int, classes: int):
    """YOLOv3 head: logistic on x,y and obj+classes; w,h raw
    (reference: forward_yolo_layer_cpu, src/yolov2_forward_network.c:453-473).
    ``[B,H,W,n*(5+classes)]`` in and out."""
    b, h, w, _ = x.shape
    y = x.reshape(b, h, w, n, 5 + classes)
    y = torch.cat([torch.sigmoid(y[..., 0:2]), y[..., 2:4],
                   torch.sigmoid(y[..., 4:])], dim=-1)
    return y.reshape(b, h, w, n * (5 + classes))


def _group_softmax(x, group_sizes) -> list:
    """A softmax over each run of ``group_sizes`` consecutive entries of the
    last axis, in order (the softmax tree's groups)."""
    parts, start = [], 0
    for gs in group_sizes:
        parts.append(torch.softmax(x[..., start:start + gs], dim=-1))
        start += gs
    return parts


def region_head(x, n: int, classes: int, coords: int, do_softmax: bool,
                softmax_tree_groups=None):
    """YOLOv2 region head: logistic on t0; softmax over classes
    (reference: forward_region_layer_cpu, src/yolov2_forward_network.c:511-576).
    x,y stay raw (their logistic is applied at decode). Returns
    ``[B,H,W,n,coords+1+classes]``. ``softmax_tree_groups`` (YOLO9000's
    tree): a softmax over each group of consecutive classes instead."""
    b, h, w, _ = x.shape
    y = x.reshape(b, h, w, n, coords + 1 + classes)
    t0 = torch.sigmoid(y[..., coords:coords + 1])
    cls = y[..., coords + 1:]
    if softmax_tree_groups:
        cls = torch.cat(_group_softmax(cls, softmax_tree_groups), dim=-1)
    elif do_softmax:
        cls = torch.softmax(cls, dim=-1)
    return torch.cat([y[..., :coords], t0, cls], dim=-1)


def softmax_layer(x, groups: int, temperature: float, tree_groups=None):
    """[softmax] layer. The reference never dispatches its forward (the
    constructor comments it out, src/additionally.c:2313); the JAX package
    and the port run it: softmax_cpu semantics
    (src/yolov2_forward_network.c:476-491) over ``groups`` equal parts of
    each flattened input, or the grouped softmax_tree variant (:494-505)
    when the cfg supplies ``tree=``. Returns ``[B, inputs]``."""
    b = x.shape[0]
    ten = torch.tensor(temperature, dtype=torch.float32, device=x.device)
    if tree_groups:
        return torch.cat(_group_softmax(x.reshape(b, -1) / ten, tree_groups),
                         dim=-1)
    y = torch.softmax(x.reshape(b, groups, -1) / ten, dim=-1)
    return y.reshape(b, -1)
