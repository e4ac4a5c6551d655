# Mirrors yolo2_light_tpu/post/boxes_legacy.py: a copy, so that the port
# imports nothing of the JAX package.
"""Legacy training-era box math (inventory parity, SURVEY §2.7).

The reference ships a family of box-gradient helpers that are dead code in
yolo2_light — nothing on any CLI path calls them — but they are part of the
box.c surface, so they are reproduced here for inventory completeness:

* ``derivative`` / ``dintersect`` / ``dunion`` / ``diou`` —
  the reference's src/box.c:16-64,106-133,208-235: piecewise-constant
  sub-gradients of overlap/intersection/union w.r.t. the first box, and the
  IoU-loss step. NOTE the reference's ``diou`` guard reads ``if(i <= 0 || 1)``
  (box.c:216) — the ``|| 1`` makes the early branch unconditional, so the
  analytic quotient-rule formula below it is unreachable; ``diou`` ALWAYS
  returns the plain coordinate deltas ``b - a``. That behavior (not the dead
  formula) is what this module reproduces; the dead formula is kept as
  ``diou_analytic`` so the finite-difference check the reference sketches in
  ``test_box`` (box.c:185-208) can exercise the math it was meant to have.
* ``box_rmse`` — box.c:97-103: 4-coordinate RMSE between two boxes.
* ``encode_box`` / ``decode_box`` — box.c:350-368: anchor-relative
  (log2-width) box coding, exact inverses of each other.

Unlike the C structs-of-scalars, everything here is vectorized NumPy over
``(..., 4)`` ``[x, y, w, h]`` center-format arrays (the same layout
post/boxes.py uses), broadcasting like any other array op. The gradients are
checked against central finite differences in tests/test_boxes_legacy.py —
the reference's own validation idea (test_dintersect/test_dunion/test_box,
box.c:136-208).
"""

from __future__ import annotations

import numpy as np

__all__ = ["derivative", "dintersect", "dunion", "diou", "diou_analytic",
           "box_rmse", "encode_box", "decode_box"]


def _inter_wh(a, b):
    """Signed 1-D overlaps (w, h) of the two boxes (box.c:66-84)."""
    aw, ah = a[..., 2], a[..., 3]
    bw, bh = b[..., 2], b[..., 3]
    w = (np.minimum(a[..., 0] + aw / 2, b[..., 0] + bw / 2)
         - np.maximum(a[..., 0] - aw / 2, b[..., 0] - bw / 2))
    h = (np.minimum(a[..., 1] + ah / 2, b[..., 1] + bh / 2)
         - np.maximum(a[..., 1] - ah / 2, b[..., 1] - bh / 2))
    return w, h


def _axis_derivative(c1, w1, c2, w2):
    """One axis of ``derivative`` (box.c:16-64): the sub-gradient of the 1-D
    overlap length w.r.t. the first interval's (center, width). Each clipped
    edge contributes ∓1 to d_center and +1/2 to d_width; fully-disjoint
    intervals collapse to the pure approach direction (d_width = 0)."""
    l1, l2 = c1 - w1 / 2, c2 - w2 / 2
    r1, r2 = c1 + w1 / 2, c2 + w2 / 2
    dc = np.where(l1 > l2, -1.0, 0.0) + np.where(r1 < r2, 1.0, 0.0)
    dw = (np.where(l1 > l2, 0.5, 0.0) + np.where(r1 < r2, 0.5, 0.0))
    dc = np.where(l1 > r2, -1.0, dc)
    dw = np.where(l1 > r2, 0.0, dw)
    dc = np.where(r1 < l2, 1.0, dc)
    dw = np.where(r1 < l2, 0.0, dw)
    return dc, dw


def derivative(a, b):
    """d(1-D overlaps)/d(a) as an ``(..., 4)`` ``[dx, dy, dw, dh]`` array
    (box.c:16-64): x/w from the horizontal overlap, y/h from the vertical."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    dx, dw = _axis_derivative(a[..., 0], a[..., 2], b[..., 0], b[..., 2])
    dy, dh = _axis_derivative(a[..., 1], a[..., 3], b[..., 1], b[..., 3])
    return np.stack([dx, dy, dw, dh], axis=-1).astype(np.float32)


def dintersect(a, b):
    """d(intersection area)/d(a) (box.c:106-119): product rule — each axis's
    overlap sub-gradient scaled by the OTHER axis's overlap length. Matches
    central finite differences wherever the intersection is positive and no
    edge-order tie sits inside the probe step."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    w, h = _inter_wh(a, b)
    d = derivative(a, b)
    # x and w move horizontal edges -> scaled by the vertical overlap h;
    # y and h move vertical edges -> scaled by the horizontal overlap w
    scale = np.stack([h, w, h, w], axis=-1)
    return (d * scale).astype(np.float32)


def dunion(a, b):
    """d(union area)/d(a) (box.c:121-133): d(area_a) - d(intersection);
    area_a = w*h contributes (0, 0, h, w)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    di = dintersect(a, b)
    zeros = np.zeros_like(a[..., 0])
    darea = np.stack([zeros, zeros, a[..., 3], a[..., 2]], axis=-1)
    return (darea - di).astype(np.float32)


def diou(a, b):
    """The IoU-loss step the reference ACTUALLY computes (box.c:208-235):
    the guard ``if(i <= 0 || 1)`` short-circuits unconditionally, so this is
    just the coordinate deltas ``b - a`` — a plain pull of box ``a`` toward
    box ``b``. See ``diou_analytic`` for the dead formula behind the guard."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return (b - a).astype(np.float32)


def diou_analytic(a, b):
    """The unreachable branch of the reference's ``diou`` (box.c:227-232):
    ``2*(1-i/u) * (di*u - du*i) / u^2``. Note the SIGN: by the chain rule
    d((1-IoU)^2)/da = -2*(1-i/u)*(di*u - i*du)/u^2 — the reference formula is
    the NEGATIVE of the loss gradient (the descent direction). Its own
    test_box (box.c:185-208) prints analytic vs finite-difference side by
    side and would show the flip; it never asserts. Reproduced as written;
    tests/test_boxes_legacy.py pins got == -fd((1-IoU)^2)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    w, h = _inter_wh(a, b)
    i = np.where((w < 0) | (h < 0), 0.0, w * h).astype(np.float32)
    u = (a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - i).astype(np.float32)
    di, du = dintersect(a, b), dunion(a, b)
    coef = (2.0 * (1.0 - i / u) / (u * u))[..., None]
    return (coef * (di * u[..., None] - du * i[..., None])).astype(np.float32)


def box_rmse(a, b):
    """4-coordinate RMSE between boxes (box.c:97-103)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.sqrt(np.sum((a - b) ** 2, axis=-1, dtype=np.float32))


def encode_box(b, anchor):
    """Anchor-relative coding (box.c:350-358): offsets in anchor units,
    log2-ratio widths."""
    b = np.asarray(b, np.float32)
    anchor = np.asarray(anchor, np.float32)
    return np.stack([
        (b[..., 0] - anchor[..., 0]) / anchor[..., 2],
        (b[..., 1] - anchor[..., 1]) / anchor[..., 3],
        np.log2(b[..., 2] / anchor[..., 2]),
        np.log2(b[..., 3] / anchor[..., 3]),
    ], axis=-1).astype(np.float32)


def decode_box(b, anchor):
    """Inverse of ``encode_box`` (box.c:360-368)."""
    b = np.asarray(b, np.float32)
    anchor = np.asarray(anchor, np.float32)
    return np.stack([
        b[..., 0] * anchor[..., 2] + anchor[..., 0],
        b[..., 1] * anchor[..., 3] + anchor[..., 1],
        np.exp2(b[..., 2]) * anchor[..., 2],
        np.exp2(b[..., 3]) * anchor[..., 3],
    ], axis=-1).astype(np.float32)
