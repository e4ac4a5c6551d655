"""On-device darknet-exact bilinear resize.

Counterpart of ``yolo2_light_tpu/ops/resize.py`` (``_taps``,
``device_resize_image``), with the same math, op order and endpoint rules as
the host implementation (``io/image.resize_image``; reference: resize_image,
src/additionally.c:3021-3064): separable H-then-V passes, scale =
(in-1)/(out-1), the last output column (and any column when in_w == 1) copies
the source edge, the last output row gets no second tap (it keeps its (1-dy)
weight even when dy > 0).

Tap indices and weights are computed once per (source, net) size with the
same NumPy float32 arithmetic the host path uses and kept on the device
(:class:`Resizer`), so a resize is four gathers, multiplies and adds with no
host copy: it can run inside a captured CUDA graph. Each multiply and add
rounds on its own (no FMA), the strict float32 of the reference; the JAX
version's XLA backend contracts one of them into an FMA, so the two agree to
1 ULP.
"""

from __future__ import annotations

import numpy as np
import torch


def _taps(in_dim: int, out_dim: int):
    """(i0, i1, frac): int32 tap indices + f32 second-tap weights, bit-matching
    io/image.resize_image's index arithmetic (np.float32 throughout)."""
    pos = np.arange(out_dim, dtype=np.float32)
    scale = (np.float32((in_dim - 1) / (out_dim - 1))
             if out_dim > 1 else np.float32(0))
    s = pos * scale
    i0 = s.astype(np.int32)
    frac = s - i0
    i1 = np.minimum(i0 + 1, in_dim - 1)
    edge = (np.arange(out_dim) == out_dim - 1) | (in_dim == 1)
    i0 = np.where(edge, in_dim - 1, i0).astype(np.int32)
    i1 = np.where(edge, in_dim - 1, i1).astype(np.int32)
    frac = np.where(edge, np.float32(0), frac).astype(np.float32)
    return i0, i1, frac


def _row_taps(in_h: int, h: int):
    """The vertical pass's taps: every row keeps its RAW (1-dy) first-tap
    weight (the reference's float scale can land the last row fractionally
    short of in_h-1); only rows with a second tap get +dy."""
    pos = np.arange(h, dtype=np.float32)
    scale = np.float32((in_h - 1) / (h - 1)) if h > 1 else np.float32(0)
    s = pos * scale
    iy0 = np.minimum(s.astype(np.int32), in_h - 1).astype(np.int32)
    dy_raw = (s - s.astype(np.int32)).astype(np.float32)
    second = ~((np.arange(h) == h - 1) | (in_h == 1))
    iy1 = np.where(second, np.minimum(iy0 + 1, in_h - 1), iy0).astype(np.int32)
    dy2 = np.where(second, dy_raw, np.float32(0)).astype(np.float32)
    return iy0, iy1, dy_raw, dy2


class Resizer:
    """The resize of ``[B, in_h, in_w, C]`` frames to ``[B, h, w, C]``, its
    taps held on ``device``."""

    def __init__(self, in_h: int, in_w: int, h: int, w: int, device):
        device = torch.device(device)

        def dev(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(device, dtype if dtype is not None else t.dtype)

        ix0, ix1, dx = _taps(in_w, w)
        iy0, iy1, dy_raw, dy2 = _row_taps(in_h, h)
        self.ix0, self.ix1 = dev(ix0, torch.int64), dev(ix1, torch.int64)
        # 1 - dx in float32 on the host, as the reference computes it
        self.wx0 = dev((np.float32(1) - dx)[None, None, :, None])
        self.wx1 = dev(dx[None, None, :, None])
        self.iy0, self.iy1 = dev(iy0, torch.int64), dev(iy1, torch.int64)
        self.wy0 = dev((np.float32(1) - dy_raw)[None, :, None, None])
        self.wy1 = dev(dy2[None, :, None, None])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        part = (x.index_select(2, self.ix0) * self.wx0
                + x.index_select(2, self.ix1) * self.wx1)
        return (part.index_select(1, self.iy0) * self.wy0
                + part.index_select(1, self.iy1) * self.wy1)


def device_resize_image(x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """[B, ih, iw, C] float32 in [0,1] -> [B, h, w, C], darknet-exact, on
    ``x``'s device; identity dims return ``x`` untouched."""
    ih, iw = int(x.shape[1]), int(x.shape[2])
    if (ih, iw) == (h, w):
        return x
    return Resizer(ih, iw, h, w, x.device)(x)
