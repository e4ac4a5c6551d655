"""On-device detection decode + candidate compaction.

Counterpart of ``yolo2_light_tpu/post/device_decode.py``. The reference
decodes boxes on the host from full feature maps (get_network_boxes,
src/additionally.c:4403); here the boxes and class probs are decoded on the
device, probs are zeroed at the threshold exactly like the reference, and
the candidates are compacted to the top-K by best class prob, so only
[K, 4+1+classes] floats per image leave the card. Exact greedy NMS then runs
on the host over K boxes (``post/boxes.do_nms_sort``) or on the device
(``post/device_nms``).

:class:`Decoder` holds each head's constants (anchors, grid offsets, the
divisors, the softmax tree's index vectors) on the device, made once, so a
decode launches no host copy and can run inside a captured CUDA graph. The
divisions by the grid size and the net size are by 0-d device tensors: on
CUDA, division by a Python number multiplies by its reciprocal (ROADMAP F9),
which the host decode does not.

Selection: ``jax.lax.top_k`` takes the top-k set with ties broken toward the
lower index; a stable descending sort's first k rows are that set in that
order (``torch.topk`` promises no tie order).

K must be >= the number of boxes with any prob > thresh for exactness (boxes
with all-zero probs can neither print nor suppress — see do_nms_sort's
``if prob[k]==0 continue``); ``valid_count`` lets callers detect overflow.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cfg import RegionSpec, YoloSpec


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32)).to(device)


class _HeadConsts:
    """One head's decode constants on ``device``."""

    def __init__(self, spec, shape, netw: int, neth: int, device):
        _, lh, lw, n, _ = shape
        self.cols = torch.arange(lw, dtype=torch.float32,
                                 device=device)[None, None, :, None]
        self.rows = torch.arange(lh, dtype=torch.float32,
                                 device=device)[None, :, None, None]
        self.lw, self.lh = _f32(lw, device), _f32(lh, device)
        anchors = np.asarray(spec.anchors, np.float32)
        if isinstance(spec, YoloSpec):
            mask = np.asarray(spec.mask)
            self.aw = _f32(anchors[2 * mask], device)[None, None, None, :]
            self.ah = _f32(anchors[2 * mask + 1], device)[None, None, None, :]
            self.netw, self.neth = _f32(netw, device), _f32(neth, device)
            # scale_x_y's multiplier and offset (None at 1: no op at all)
            self.sxy = scale_xy_terms(spec.scale_x_y)
            if self.sxy is not None:
                self.sxy = tuple(_f32(v, device) for v in self.sxy)
            return
        self.aw = _f32(anchors[0::2][:n], device)[None, None, None, :]
        self.ah = _f32(anchors[1::2][:n], device)[None, None, None, :]
        tree = spec.softmax_tree
        if tree is None:
            return
        # the softmax tree's levels: parents always precede children
        parent = np.asarray(tree.parent)
        depth = np.zeros(tree.n, np.int64)
        for j in range(tree.n):
            if parent[j] >= 0:
                depth[j] = depth[parent[j]] + 1
        self.levels = []
        for d in range(1, int(depth.max()) + 1 if tree.n else 1):
            idx = np.nonzero(depth == d)[0]
            if idx.size:
                self.levels.append(
                    (torch.as_tensor(idx).to(device),
                     torch.as_tensor(parent[idx].astype(np.int64)).to(device)))
        if spec.class_map is not None:
            self.class_map = torch.as_tensor(
                np.asarray(spec.class_map, np.int64)).to(device)


def scale_xy_terms(scale_x_y: float):
    """(multiplier, offset) of a yolo head's ``scale_x_y`` as float32
    values, or None at 1: AlexeyAB/darknet's forward_yolo_layer maps x and
    y after the logistic to ``x * s + b``, ``b = -0.5 * (s - 1)``
    (scal_add_cpu, float32 operands, two roundings). At ``s = 1`` that is
    ``x`` exactly, so a head without the key keeps yolo2_light's decode."""
    s = np.float32(scale_x_y)
    if s == 1:
        return None
    return s, np.float32(-0.5) * (s - np.float32(1))


def _decode_yolo(h, spec: YoloSpec, c: _HeadConsts, thresh: float):
    """[B,H,W,n,5+classes] -> boxes [B,N,4], obj [B,N], probs [B,N,C]
    (reference math: get_yolo_box, src/additionally.c:4317-4325; x and y
    through ``scale_x_y`` first where the head has one)."""
    b, lh, lw, n, _ = h.shape
    sx, sy = h[..., 0], h[..., 1]
    if c.sxy is not None:
        sx = sx * c.sxy[0] + c.sxy[1]
        sy = sy * c.sxy[0] + c.sxy[1]
    bx = (c.cols + sx) / c.lw
    by = (c.rows + sy) / c.lh
    bw = torch.exp(h[..., 2]) * c.aw / c.netw
    bh = torch.exp(h[..., 3]) * c.ah / c.neth
    obj = h[..., 4]
    # detection exists only when obj > thresh (reference:
    # src/additionally.c:4340)
    exists = obj > thresh
    probs = h[..., 5:] * obj[..., None]
    probs = torch.where(probs > thresh, probs, 0.0) * exists[..., None]
    boxes = torch.stack([bx, by, bw, bh], dim=-1)
    N = lh * lw * n
    return (boxes.reshape(b, N, 4), obj.reshape(b, N),
            probs.reshape(b, N, -1))


def _decode_region(h, spec: RegionSpec, c: _HeadConsts, thresh: float):
    """[B,H,W,n,coords+1+classes] -> the same triple (reference math:
    get_region_box_cpu/get_region_boxes_cpu,
    src/yolov2_forward_network.c:653-726)."""
    b, lh, lw, n, _ = h.shape
    coords = spec.coords
    bx = (c.cols + torch.sigmoid(h[..., 0])) / c.lw
    by = (c.rows + torch.sigmoid(h[..., 1])) / c.lh
    bw = torch.exp(h[..., 2]) * c.aw / c.lw
    bh = torch.exp(h[..., 3]) * c.ah / c.lh
    scale = h[..., coords]
    if spec.classfix == -1:
        scale = torch.where(scale < 0.5, 0.0, scale)
    if spec.softmax_tree is not None:
        # YOLO9000 hierarchy: cascade parent products level by level, then
        # keep only the deepest node with path-prob > 0.5 per box;
        # prob_j = (scale > thresh) ? pred_j : 0 (reference:
        # src/additionally.c:1878 + src/yolov2_forward_network.c:694)
        preds = h[..., coords + 1:].clone()
        for idx, par in c.levels:
            preds[..., idx] = preds[..., idx] * preds[..., par]
        if spec.class_map is not None:
            # map-file decode (reference: src/yolov2_forward_network.c:694-698):
            # prob_j = scale * preds[map[j]], zeroed at <= thresh; columns
            # past the map stay zero
            sel = preds[..., c.class_map] * scale[..., None]
            sel = torch.where(sel > thresh, sel, 0.0)
            probs = torch.zeros(preds.shape[:-1] + (spec.classes,),
                                dtype=preds.dtype, device=preds.device)
            probs[..., :sel.shape[-1]] = sel
        else:
            over = preds > 0.5
            classes_n = preds.shape[-1]
            # the highest index with pred > 0.5 (argmax of the reversed
            # mask takes the first maximum), -1 where there is none
            rev_first = torch.argmax(over.flip(-1).to(torch.uint8), dim=-1)
            keep_idx = torch.where(over.any(-1), classes_n - 1 - rev_first,
                                   -1)
            onehot = (torch.arange(classes_n, device=preds.device)
                      == keep_idx[..., None])
            probs = torch.where(onehot, preds, 0.0)
            probs = torch.where((scale > thresh)[..., None], probs, 0.0)
    else:
        probs = h[..., coords + 1:] * scale[..., None]
        probs = torch.where(probs > thresh, probs, 0.0)
    boxes = torch.stack([bx, by, bw, bh], dim=-1)
    N = lh * lw * n
    return (boxes.reshape(b, N, 4),
            torch.ones((b, N), dtype=torch.float32, device=h.device),
            probs.reshape(b, N, -1))


class Decoder:
    """Decode + top-k compaction of one net's heads at fixed head shapes,
    with every constant on ``device``. ``head_shapes``: each head's
    ``[B,H,W,n,entries]`` shape (only H, W and n are read)."""

    def __init__(self, head_specs, head_shapes, netw: int, neth: int,
                 thresh: float, k: int, device, decode_order: bool = False):
        self.head_specs = list(head_specs)
        self.thresh = thresh
        self.k = k
        self.decode_order = decode_order
        self.consts = []
        for spec, shape in zip(self.head_specs, head_shapes):
            if not isinstance(spec, (YoloSpec, RegionSpec)):
                raise TypeError(type(spec))
            self.consts.append(_HeadConsts(spec, shape, netw, neth, device))

    def decode(self, heads):
        """(boxes [B,k,4], objectness [B,k], probs [B,k,C], valid_count [B])."""
        parts = []
        for h, spec, c in zip(heads, self.head_specs, self.consts):
            fn = _decode_yolo if isinstance(spec, YoloSpec) else _decode_region
            parts.append(fn(h, spec, c, self.thresh))
        boxes = torch.cat([p[0] for p in parts], dim=1)
        obj = torch.cat([p[1] for p in parts], dim=1)
        probs = torch.cat([p[2] for p in parts], dim=1)
        score = probs.amax(dim=-1)                           # [B,N]
        valid_count = (score > 0).sum(dim=-1, dtype=torch.int32)
        k = min(self.k, score.shape[1])
        idx = torch.sort(score, dim=1, descending=True, stable=True).indices
        idx = idx[:, :k]
        if self.decode_order:
            idx = torch.sort(idx, dim=1).values              # unique -> stable
        return (torch.take_along_dim(boxes, idx[..., None], dim=1),
                torch.take_along_dim(obj, idx, dim=1),
                torch.take_along_dim(probs, idx[..., None], dim=1),
                valid_count)

    def packed(self, heads) -> torch.Tensor:
        """One packed buffer [B, k, 4+1+classes] = (box, objectness,
        probs...)."""
        boxes, obj, probs, _ = self.decode(heads)
        return torch.cat([boxes, obj[..., None], probs], dim=-1)


def decode_and_compact(heads, head_specs, netw: int, neth: int, thresh: float,
                       k: int = 256, decode_order: bool = False):
    """Decode all heads, zero sub-threshold probs, select the top-k
    candidates by best class prob. Returns (boxes [B,k,4], objectness
    [B,k], probs [B,k,C], valid_count [B]).

    ``decode_order=True`` re-sorts the selected k rows by their DECODE index
    (heads in network order, cells row-major, anchors inner) instead of
    leaving them in top-k score order. The selected SET is identical; the
    order matters for exact-prob ties downstream: the reference's host NMS
    tie-breaks on the decode-order array (box.c:296-328 + stable glibc
    qsort)."""
    heads = [torch.as_tensor(h) for h in heads]
    dec = Decoder(head_specs, [h.shape for h in heads], netw, neth, thresh, k,
                  heads[0].device, decode_order)
    return dec.decode(heads)


def decode_and_compact_packed(heads, head_specs, netw: int, neth: int,
                              thresh: float, k: int = 256,
                              decode_order: bool = False):
    """Like :func:`decode_and_compact` but returns ONE packed buffer
    [B, k, 4+1+classes] = (box, objectness, probs...). K-overflow is
    detectable on the host: all k slots having a nonzero prob means
    candidates may have been dropped."""
    heads = [torch.as_tensor(h) for h in heads]
    dec = Decoder(head_specs, [h.shape for h in heads], netw, neth, thresh, k,
                  heads[0].device, decode_order)
    return dec.packed(heads)


def compact_to_detections(boxes, obj, probs, valid_count, w: int, h: int,
                          netw: int, neth: int, relative: bool = True,
                          letter: bool = False):
    """Host side: one image's compacted candidates -> Detections (drops
    all-zero-prob slots, applies correct_yolo_boxes)."""
    from .boxes import Detections, correct_boxes

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)

    boxes, obj, probs = host(boxes), host(obj), host(probs)
    keep = probs.max(axis=-1) > 0
    boxes, obj, probs = boxes[keep], obj[keep], probs[keep]
    boxes = correct_boxes(boxes.astype(np.float32), w, h, netw, neth,
                          relative, letter)
    return Detections(boxes.astype(np.float32), obj.astype(np.float32),
                      probs.astype(np.float32))
