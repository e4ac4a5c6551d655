"""The plain reference of a YOLO detector's input and output stages.

* :func:`ingest`: uint8 frames to the net's input, as darknet loads and
  resizes an image (load_image_stb's ``/ 255``, resize_image of
  src/image.c: a horizontal pass, then a vertical one; the scale is
  ``(in - 1) / (out - 1)`` in float32, the last column copies the source's
  last, the last row takes no second tap).
* :func:`decode`: the heads to candidate boxes and class scores
  (get_yolo_box and get_yolo_detections of src/yolo_layer.c): a candidate
  exists where its objectness exceeds the threshold, and a class's score,
  objectness times the class's probability, counts where it exceeds the
  threshold too.
* :func:`nms`: darknet's do_nms_sort, per class: the candidates in
  descending score (ties in candidate order), each survivor zeroing the
  class in every later candidate whose IoU with it exceeds the threshold.
* :func:`correct_boxes`: correct_yolo_boxes for a frame stretched to the
  net (no letterbox).

Each operation is a plain ``torch`` op; divisions are by tensors, which
PyTorch's CUDA kernels divide exactly, where a Python number would be
applied as the product with its reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from .cfg import Net


def _taps(in_dim: int, out_dim: int):
    scale = (np.float32((in_dim - 1) / (out_dim - 1)) if out_dim > 1
             else np.float32(0))
    s = np.arange(out_dim, dtype=np.float32) * scale
    i0 = s.astype(np.int64)
    d = (s - i0.astype(np.float32)).astype(np.float32)
    return i0, d


def ingest(frames: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` -> float32 ``[B, h, w, C]`` in [0, 1]."""
    dev = frames.device
    x = frames.float() / torch.full((), 255.0, device=dev)
    ih, iw = x.shape[1], x.shape[2]
    if (ih, iw) == (h, w):
        return x
    ix, dx = _taps(iw, w)
    ix1 = np.minimum(ix + 1, iw - 1)
    last_c = (np.arange(w) == w - 1) | (iw == 1)
    ix = np.where(last_c, iw - 1, ix)
    ix1 = np.where(last_c, iw - 1, ix1)
    dx = np.where(last_c, np.float32(0), dx).astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    wx0 = t((np.float32(1) - dx)[None, None, :, None])
    wx1 = t(dx[None, None, :, None])
    part = (x.index_select(2, t(ix, torch.int64)) * wx0
            + x.index_select(2, t(ix1, torch.int64)) * wx1)
    iy, dy = _taps(ih, h)
    iy = np.minimum(iy, ih - 1)
    second = ~((np.arange(h) == h - 1) | (ih == 1))
    iy1 = np.where(second, np.minimum(iy + 1, ih - 1), iy)
    wy0 = t((np.float32(1) - dy)[None, :, None, None])
    out = part.index_select(1, t(iy, torch.int64)) * wy0
    wy1 = t(np.where(second, dy, np.float32(0))[None, :, None, None])
    return out + part.index_select(1, t(iy1, torch.int64)) * wy1


def decode(net: Net, heads: list, thresh: float) -> tuple:
    """Activated heads -> (boxes ``[B, N, 4]`` centre x, y, w, h relative to
    the net, scores ``[B, N, C]`` before the threshold, kept scores
    ``[B, N, C]``), candidates in darknet's order: heads in layer order,
    cells row by row, anchors within a cell."""
    boxes, raws, kept = [], [], []
    for l, hd in zip(net.heads, heads):
        dev = hd.device
        b = hd.shape[0]

        def f(v):
            return torch.as_tensor(np.asarray(v, np.float32)).to(dev)

        anchors = np.asarray(l.anchors, np.float32)
        mask = np.asarray(l.mask)
        cols = torch.arange(l.w, dtype=torch.float32,
                            device=dev)[None, None, :, None]
        rows = torch.arange(l.h, dtype=torch.float32,
                            device=dev)[None, :, None, None]
        bx = (cols + hd[..., 0]) / f(l.w)
        by = (rows + hd[..., 1]) / f(l.h)
        bw = torch.exp(hd[..., 2]) * f(anchors[2 * mask]) / f(net.w)
        bh = torch.exp(hd[..., 3]) * f(anchors[2 * mask + 1]) / f(net.h)
        obj = hd[..., 4]
        raw = hd[..., 5:] * obj[..., None]
        keep = torch.where(raw > thresh, raw, 0.0) * (obj > thresh)[..., None]
        boxes.append(torch.stack([bx, by, bw, bh], -1).reshape(b, -1, 4))
        raws.append(raw.reshape(b, -1, l.classes))
        kept.append(keep.reshape(b, -1, l.classes))
    return torch.cat(boxes, 1), torch.cat(raws, 1), torch.cat(kept, 1)


def correct_boxes(boxes: np.ndarray, w: int, h: int, netw: int,
                  neth: int) -> np.ndarray:
    """correct_yolo_boxes for a frame of ``w`` x ``h`` stretched to the net:
    relative coordinates stay relative to the frame."""
    new_w, new_h = netw, neth
    b = boxes.astype(np.float64).copy()
    b[:, 0] = (b[:, 0] - (netw - new_w) / 2.0 / netw) / (new_w / netw)
    b[:, 1] = (b[:, 1] - (neth - new_h) / 2.0 / neth) / (new_h / neth)
    b[:, 2] *= netw / new_w
    b[:, 3] *= neth / new_h
    return b


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of centre-format boxes ``[N, 4]`` x ``[M, 4]`` (darknet's
    box_iou: no overlap below zero, no epsilon)."""
    ax1, ax2 = a[:, 0] - a[:, 2] / 2, a[:, 0] + a[:, 2] / 2
    ay1, ay2 = a[:, 1] - a[:, 3] / 2, a[:, 1] + a[:, 3] / 2
    bx1, bx2 = b[:, 0] - b[:, 2] / 2, b[:, 0] + b[:, 2] / 2
    by1, by2 = b[:, 1] - b[:, 3] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.minimum(ax2[:, None], bx2[None]) - np.maximum(ax1[:, None],
                                                          bx1[None])
    ih = np.minimum(ay2[:, None], by2[None]) - np.maximum(ay1[:, None],
                                                          by1[None])
    inter = np.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """do_nms_sort over one frame's candidates (``scores`` ``[N, C]`` after
    the threshold; a zero is no detection). Returns the scores left."""
    out = scores.copy()
    live = np.nonzero(out.max(axis=1) > 0)[0]
    if live.size == 0 or not thresh:
        return out
    ov = iou(boxes[live], boxes[live]) > thresh
    for c in range(out.shape[1]):
        col = out[live, c]
        order = np.argsort(-col, kind="stable")
        order = order[col[order] > 0]
        alive = np.ones(live.size, bool)
        for r, i in enumerate(order):
            if not alive[i]:
                continue
            later = order[r + 1:]
            gone = later[ov[i, later]]
            alive[gone] = False
        dead = live[[i for i in order if not alive[i]]]
        out[dead, c] = 0.0
    return out
