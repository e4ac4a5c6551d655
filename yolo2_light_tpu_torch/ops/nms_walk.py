"""The rank walk of exact greedy NMS: the hand-written Hopper kernel and its
plain PyTorch twin.

``ops/nms_order`` (K7) builds, for a batch of B images of K candidates and
C classes, the overlap bits (IoU > thresh), each class's walk order (the
carried stable-argsort chain) and the highest prob at each rank; what is
left is the walk of ``yolo2_light_tpu/post/device_nms.py``
(:93-109), a ``lax.while_loop`` with a data-dependent stop:

    for t while t < K and rank_has_work[t] > 0:
        for every class c:
            cur = order[c, t]
            if probs[cur, c] != 0:                    # survived ranks < t
                probs[j, c] = 0 for every j with over[cur, j] and rank_c(j) > t

A suppressed box never suppresses. ``csrc/nms_walk.cu`` runs it with one
warp per (image, class) and a block per image and eight classes: the classes
are independent (class c's walk reads and writes column c only), the stop
rank is the image's. It replaces an XLA loop, not a Pallas kernel: done with
PyTorch ops it would be up to K launches and a host round trip per rank, or
a host sync to count the ranks, neither of which a CUDA graph can hold.

Layout of ``over``: one bit per pair, ``[B, K, ceil(K/32)]`` int32 rows (bit
b of word w of row i is column 32w+b; :func:`pack_rows`), 2 MB an image at
K = 4096 against 16 MB as bytes. The walk reads one row per live rank and
class, so its traffic is C rows per rank: bits make a row 512 bytes at
K = 4096, one 16-byte load a lane.

Dispatch: :func:`nms_walk` launches the kernel for a CUDA tensor and runs
:func:`nms_walk_plain` for a CPU tensor; the CUDA path never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .int8_conv import LAUNCH_COUNTS

_KERNEL = "nms_walk"
MAX_K = 8192          # the kernel keeps at most 8 words of a row a lane


def words_for(k: int) -> int:
    return -(-k // 32)


def pack_rows(over: torch.Tensor) -> torch.Tensor:
    """bool ``[B, K, K]`` -> int32 ``[B, K, ceil(K/32)]``: bit b of word w of
    row i is ``over[:, i, 32w+b]``, pad bits 0. Bytes are weighted and summed
    (distinct bits, so the sum is an or) and the bytes read as little-endian
    words. Device ops only: it runs inside a captured graph."""
    b, k, k2 = over.shape
    pad = words_for(k2) * 32 - k2
    bits = over.view(torch.uint8)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=over.device)).to(torch.uint8)
    packed = (bits.reshape(b, k, -1, 8) * weights).sum(-1, dtype=torch.uint8)
    return packed.view(torch.int32)


def unpack_rows(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows`: ``[B, K, W]`` int32 -> bool
    ``[B, K, k]``."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    out = ((bits[..., None] >> shifts) & 1).bool()
    return out.reshape(bits.shape[0], bits.shape[1], -1)[..., :k]


# ---------------------------------------------------------------------------
# Plain version (CPU tensors on the main path; the reference on the card)
# ---------------------------------------------------------------------------


def nms_walk_plain(over_bits, order, rank_has_work, probs):
    """The JAX walk as a loop over ranks, every image of the batch at once
    (an image whose walk has stopped keeps its probs, as under ``vmap``).

    ``over_bits`` [B,K,W] int32 (:func:`pack_rows`), ``order`` [B,C,K] int32
    (``order[b, c, t]`` = candidate at rank t of class c), ``rank_has_work``
    [B,K] f32 (the highest prob at each rank), ``probs`` [B,K,C] f32.
    Returns the suppressed probs, a new tensor."""
    b, k, c = probs.shape
    over = unpack_rows(over_bits, k)
    order = order.long()
    rank = torch.argsort(order, dim=2)            # rank[b, c, j]
    # the first rank with no work ends the walk (rank_has_work falls)
    live = rank_has_work > 0
    stop = torch.where(live.all(dim=1), k,
                       torch.argmin(live.to(torch.uint8), dim=1))
    work = probs.clone()
    bi = torch.arange(b, device=probs.device)[:, None]
    ci = torch.arange(c, device=probs.device)[None, :]
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    for t in range(int(stop.max()) if b else 0):
        cur = order[:, :, t]                                      # [B,C]
        active = (work[bi, cur, ci] != 0) & (t < stop)[:, None]   # [B,C]
        suppress = active[..., None] & over[bi, cur] & (rank > t)  # [B,C,K]
        work = torch.where(suppress.transpose(1, 2), zero, work)
    return work


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.cache
def load_kernel():
    """Build (first use) and load ``csrc/nms_walk.cu``; returns its bound
    entry point, once per process."""
    from . import _build
    fn = _build.load(_KERNEL).nms_walk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def nms_walk_cuda(over_bits, order, rank_has_work, probs):
    """Launch the kernel on the current stream of ``probs``' device; returns
    a new contiguous tensor (``probs`` itself is not written). ``probs`` may
    be a view with any batch and row stride whose last dimension is
    contiguous (the packed buffer's ``[..., 5:]``)."""
    tensors = (over_bits, order, rank_has_work, probs)
    if not (probs.is_cuda and all(t.device == probs.device for t in tensors)):
        raise ValueError("nms_walk_cuda: over_bits, order, rank_has_work and "
                         "probs must lie on one CUDA device")
    if (over_bits.dtype != torch.int32 or order.dtype != torch.int32
            or rank_has_work.dtype != torch.float32
            or probs.dtype != torch.float32):
        raise TypeError("nms_walk_cuda: over_bits and order must be int32, "
                        "rank_has_work and probs float32; got "
                        f"{over_bits.dtype}, {order.dtype}, "
                        f"{rank_has_work.dtype}, {probs.dtype}")
    if probs.dim() != 3:
        raise ValueError("nms_walk_cuda: probs must be [B, K, C]")
    b, k, c = probs.shape
    if (tuple(over_bits.shape) != (b, k, words_for(k))
            or tuple(order.shape) != (b, c, k)
            or tuple(rank_has_work.shape) != (b, k)):
        raise ValueError(f"nms_walk_cuda: shapes do not match: over_bits "
                         f"{tuple(over_bits.shape)}, order "
                         f"{tuple(order.shape)}, rank_has_work "
                         f"{tuple(rank_has_work.shape)}, probs "
                         f"{tuple(probs.shape)}")
    if k > MAX_K or b > 65535:
        raise ValueError(f"nms_walk_cuda: K={k} above {MAX_K} or B={b} "
                         "above 65535")
    if not (all(t.is_contiguous() for t in tensors[:3])
            and probs.stride(2) == 1):
        raise ValueError("nms_walk_cuda: over_bits, order and rank_has_work "
                         "must be contiguous, and probs' last dimension")
    out = torch.empty(probs.shape, dtype=probs.dtype, device=probs.device)
    if out.numel() == 0:
        return out
    kernel = load_kernel()
    stream = torch.cuda.current_stream(probs.device).cuda_stream
    LAUNCH_COUNTS[_KERNEL] += 1
    rc = kernel(over_bits.data_ptr(), order.data_ptr(),
                rank_has_work.data_ptr(), probs.data_ptr(), probs.stride(0),
                probs.stride(1), out.data_ptr(), b, k, c, probs.device.index,
                stream)
    if rc != 0:
        raise RuntimeError(f"nms_walk kernel launch failed: cudaError {rc}")
    return out


def nms_walk(over_bits, order, rank_has_work, probs):
    """The walk: the kernel for a CUDA tensor, the plain version for a CPU
    tensor (arguments as :func:`nms_walk_plain`)."""
    if probs.is_cuda:
        return nms_walk_cuda(over_bits, order, rank_has_work, probs)
    if probs.device.type != "cpu":
        raise ValueError(f"nms_walk: unsupported device {probs.device}")
    return nms_walk_plain(over_bits, order, rank_has_work, probs)
