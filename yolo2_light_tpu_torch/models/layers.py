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

from ..ops import int8_conv

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
                bn=None):
    """Dense conv + optional (unfused) BN + bias + activation.
    ``weights``: ``[O, I, kh, kw]`` float32.

    BN math (reference: src/yolov2_forward_network.c:222-239):
      y = (conv - rolling_mean) / (sqrt(rolling_variance) + 1e-6) * scales + bias
    with epsilon added OUTSIDE the sqrt. ``network.build_forward`` turns TF32 off
    (:func:`set_fp32_precision`) before any conv runs.
    """
    y = F.conv2d(x.permute(0, 3, 1, 2), weights, stride=stride, padding=pad)
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
                r_mult: int = 32, plain: bool = False):
    """INT8 conv, ``semantics="cpu"`` (reference: forward_convolutional_layer_q,
    src/yolov2_forward_network_quantized.c:527-631):

      1. quantize input: int8 = clamp(trunc(x * input_mult), +-127)
      2. int8 conv, int32 accumulation over the full K
      3. requantize: q = clamp(trunc_div(acc, R_MULT), +-32767)
      4. y = q * alpha + bias, alpha = R_MULT / (input_mult * weights_mult)
      5. LEAKY is x>0 ? x : x/10 on this path (NOT 0.1*x)

    Steps 1-5 are one launch of the int8 kernel's f32-input entry
    (``ops/int8_conv``) for a CUDA tensor; ``plain=True`` runs its plain
    PyTorch version instead (the reference the kernel is checked against).
    ``weights_int8``: ``[M, kh, kw, C]``. The ``gpu`` flavor is not ported
    yet.
    """
    epilogue = activation if activation in ("leaky", "linear") else "linear"
    if plain:
        y = int8_conv.conv2d_int8_f32_plain(x, weights_int8, biases,
                                            input_mult, alpha, stride, pad,
                                            epilogue, r_mult)
    else:
        # a conv output seen through its NHWC permute need not be
        # NHWC-dense; the kernel reads dense NHWC rows
        if not x.is_contiguous():
            if x.is_cuda:
                int8_conv.PRE_LAUNCHES["input_copy"] += 1
            x = x.contiguous()
        y = int8_conv.conv2d_int8_f32(x, weights_int8, biases, input_mult,
                                      alpha, stride, pad, epilogue, r_mult)
    if epilogue != activation:
        y = activate(y, activation)
    return y


def conv2d_xnor(x, sign_weights, mean_arr, biases, stride: int, pad: int,
                activation: str):
    """XNOR (BIT1) conv as a dense +-1 convolution, the ``-xnor_kernel int8``
    engine (reference: the popcount GEMM (2*popcount(xnor) - K) * mean,
    src/additionally.c:1185-1242, src/gpu.cu:1566-1741).
    ``sign_weights``: ``[O, I, kh, kw]`` float32 +-1; ``mean_arr``: the
    per-filter mean |w| factored out of the product.

    Input binarized to +-1 by (x > 0) (reference: binarize_cpu,
    src/additionally.c:128-135). Borders: the reference's bit path, taken
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


def maxpool(x, size: int, stride: int, pad: int, out_w: int, out_h: int):
    """Darknet maxpool: out = (in + pad - size)//stride + 1, window origin at
    ``-pad//2`` (reference: forward_maxpool_layer_avx, src/additionally.c:1041-1133:
    ``w_offset = -pad/2``). Padding is asymmetric: ``pad//2`` at the start and
    whatever the output extent needs at the end; out-of-bounds positions
    contribute -inf."""
    h, w = x.shape[1], x.shape[2]
    lo = pad // 2
    hi_h = max(0, (out_h - 1) * stride + size - lo - h)
    hi_w = max(0, (out_w - 1) * stride + size - lo - w)
    y = x.permute(0, 3, 1, 2)
    y = F.pad(y, (lo, hi_w, lo, hi_h), value=float("-inf"))
    y = F.max_pool2d(y, size, stride)
    return y.permute(0, 2, 3, 1)[:, :out_h, :out_w, :]


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


def region_head(x, n: int, classes: int, coords: int, do_softmax: bool,
                softmax_tree_groups=None):
    """YOLOv2 region head: logistic on t0; softmax over classes
    (reference: forward_region_layer_cpu, src/yolov2_forward_network.c:511-576).
    x,y stay raw (their logistic is applied at decode). Returns
    ``[B,H,W,n,coords+1+classes]``. The softmax-tree variant is not ported."""
    if softmax_tree_groups:
        raise NotImplementedError(
            "region softmax tree (YOLO9000) is not yet ported to "
            "yolo2_light_tpu_torch")
    b, h, w, _ = x.shape
    y = x.reshape(b, h, w, n, coords + 1 + classes)
    t0 = torch.sigmoid(y[..., coords:coords + 1])
    cls = y[..., coords + 1:]
    if do_softmax:
        cls = torch.softmax(cls, dim=-1)
    return torch.cat([y[..., :coords], t0, cls], dim=-1)


def softmax_layer(x, groups: int, temperature: float, tree_groups=None):
    """[softmax] layer: not yet ported."""
    raise NotImplementedError(
        "[softmax] layers are not yet ported to yolo2_light_tpu_torch")
