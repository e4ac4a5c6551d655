"""K7: everything the NMS rank walk reads, in one launch: the hand-written
Hopper kernel and its plain PyTorch twin.

For boxes [B,K,4] (center x, y, w, h) and probs [B,K,C], the rank walk
(``ops/nms_walk``) reads

* ``over_bits`` [B,K,ceil(K/32)] int32: IoU > thresh, one bit per pair
  (``nms_walk.pack_rows``);
* ``order`` [B,C,K] int32: class c's walk order, the stable descending
  argsort of its probs over the order class c-1 left behind (the carried
  qsort of ``do_nms_sort``, src/box.c:310-317);
* ``rank_has_work`` [B,K] f32: the highest prob at each rank, over classes;
* ``perm`` [B,K] int64: ``order[:, C-1]`` (the identity when C = 0), the
  post-NMS array order.

In the JAX package that is ``pairwise_iou``, ``iou > thresh``, the
``lax.scan`` of stable argsorts and ``rank_has_work`` of
``yolo2_light_tpu/post/device_nms.py:66-93``: XLA ops, no Pallas kernel. In
PyTorch ops (:func:`nms_order_plain`) the chain is 5-8 small dependent ops a
class, about 700 launches at C = 80, and the IoU a [B,K,K] float matrix.
``csrc/nms_order.cu`` computes all four in one launch, bit for bit: the
chain on one SM per image (each class step a partition and, for the nonzero
probs, the count of unique composite keys below each one), the bit rows on
the other SMs. Its note says what bounds it (the chain's depth, not bytes).

Dispatch: :func:`nms_order` launches the kernel for a CUDA tensor and runs
:func:`nms_order_plain` for a CPU tensor; the CUDA path never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .int8_conv import LAUNCH_COUNTS
from .nms_walk import pack_rows, words_for

_KERNEL = "nms_order"
MAX_K = 8192          # candidates fit the chain's int16 order in shared memory
# Class steps with at most this many nonzero probs rank them by sorted runs
# of 32 keys and binary searches; busier ones sort the keys (bitonic), which
# measured faster from about a thousand (scripts/trace_nms.py). Both give
# the same order.
COUNT_MAX = 1024


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] center-format (x,y,w,h) -> [..., K, K] IoU (reference math:
    box_iou/box_intersection/overlap, src/box.c:70-97: negative overlap =>
    intersection 0; union <= 0 => IoU 0; no epsilon)."""
    x, y, w, h = boxes.unbind(-1)
    x1, x2 = x - w / 2, x + w / 2
    y1, y2 = y - h / 2, y + h / 2
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]))
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]))
    inter = torch.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    area = w * h
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


# ---------------------------------------------------------------------------
# Plain version (CPU tensors on the main path; the reference on the card)
# ---------------------------------------------------------------------------


def nms_order_plain(boxes: torch.Tensor, probs: torch.Tensor, thresh: float):
    """(over_bits, order, rank_has_work, perm) for boxes [B,K,4] and probs
    [B,K,C], in PyTorch ops."""
    b, k, c = probs.shape
    over = pairwise_iou(boxes) > thresh
    # order[:, c, t] = candidate at sorted position t of class c: class c's
    # order is the stable descending sort of the order class c-1 left
    # behind (the carried qsort); all keys are original probs
    perm = torch.arange(k, device=probs.device).expand(b, k)
    orders = []
    for ci in range(c):
        col = torch.take_along_dim(probs[..., ci], perm, dim=1)
        perm = torch.take_along_dim(
            perm, torch.argsort(-col, dim=1, stable=True), dim=1)
        orders.append(perm)
    order = (torch.stack(orders, dim=1) if c
             else torch.zeros((b, 0, k), dtype=torch.int64,
                              device=probs.device))
    # ranks past the last nonzero prob (in EVERY class) are padding or
    # sub-threshold slots: the walk stops at the first of them. The sort
    # may place -0.0 or +0.0 where a class has zeros; + 0.0 makes such a
    # maximum +0.0 (the walk reads only > 0)
    rank_has_work = (torch.sort(probs, dim=1, descending=True).values.amax(
        dim=2) + 0.0) if c else torch.zeros((b, k), device=probs.device)
    return (pack_rows(over), order.to(torch.int32).contiguous(),
            rank_has_work.contiguous(), perm)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.cache
def load_kernel():
    """Build (first use) and load ``csrc/nms_order.cu``; returns its bound
    entry point, once per process."""
    from . import _build
    lib = _build.load(_KERNEL)
    fn = lib.nms_order
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    lib.nms_order_prepare.restype = ctypes.c_int
    lib.nms_order_prepare.argtypes = [ctypes.c_int]
    return fn


@functools.cache
def prepare(device_index: int) -> None:
    """Raise the kernel's shared memory limit on a CUDA device (K above
    2048 takes more than 48 KB): once per device, before any launch or
    capture on it."""
    load_kernel()
    from . import _build
    rc = _build.load(_KERNEL).nms_order_prepare(device_index)
    if rc != 0:
        raise RuntimeError(f"nms_order: setting the shared memory limit "
                           f"failed: cudaError {rc}")


def nms_order_cuda(boxes, probs, thresh: float, count_max: int = COUNT_MAX):
    """Launch the kernel on the current stream of ``probs``' device.
    ``boxes`` and ``probs`` may be views with any batch and row stride whose
    last dimension is contiguous (the packed buffer's ``[..., :4]`` and
    ``[..., 5:]``). ``count_max`` picks the class steps that rank by sorted
    runs, the rest sort (tests force either way). Returns new tensors."""
    if not (probs.is_cuda and boxes.device == probs.device):
        raise ValueError("nms_order_cuda: boxes and probs must lie on one "
                         "CUDA device")
    if boxes.dtype != torch.float32 or probs.dtype != torch.float32:
        raise TypeError(f"nms_order_cuda: boxes and probs must be float32; "
                        f"got {boxes.dtype}, {probs.dtype}")
    if probs.dim() != 3 or boxes.dim() != 3:
        raise ValueError("nms_order_cuda: boxes must be [B, K, 4] and probs "
                         "[B, K, C]")
    b, k, c = probs.shape
    if tuple(boxes.shape) != (b, k, 4):
        raise ValueError(f"nms_order_cuda: boxes {tuple(boxes.shape)} do not "
                         f"match probs {tuple(probs.shape)}")
    if k > MAX_K or b > 65535 or c > 65535:
        raise ValueError(f"nms_order_cuda: K={k} above {MAX_K}, or B={b} or "
                         f"C={c} above 65535")
    if boxes.stride(2) != 1 or probs.stride(2) != 1:
        raise ValueError("nms_order_cuda: the last dimension of boxes and "
                         "probs must be contiguous")
    dev = probs.device
    over = torch.empty((b, k, words_for(k)), dtype=torch.int32, device=dev)
    order = torch.empty((b, c, k), dtype=torch.int32, device=dev)
    rhw = torch.empty((b, k), dtype=torch.float32, device=dev)
    perm = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0 or k == 0:
        return over, order, rhw, perm
    kernel = load_kernel()
    prepare(dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCH_COUNTS[_KERNEL] += 1
    rc = kernel(boxes.data_ptr(), boxes.stride(0), boxes.stride(1),
                probs.data_ptr(), probs.stride(0), probs.stride(1),
                over.data_ptr(), order.data_ptr(), rhw.data_ptr(),
                perm.data_ptr(), b, k, c, thresh, count_max, dev.index,
                stream)
    if rc != 0:
        raise RuntimeError(f"nms_order kernel launch failed: cudaError {rc}")
    return over, order, rhw, perm


def nms_order(boxes, probs, thresh: float):
    """The walk's inputs: the kernel for a CUDA tensor, the plain version
    for a CPU tensor (arguments and results as :func:`nms_order_plain`)."""
    if probs.is_cuda:
        return nms_order_cuda(boxes, probs, thresh)
    if probs.device.type != "cpu":
        raise ValueError(f"nms_order: unsupported device {probs.device}")
    return nms_order_plain(boxes, probs, thresh)
