# Mirrors yolo2_light_tpu/io/image.py: a copy, so that the port imports
# nothing of the JAX package.
"""Image I/O with darknet-exact semantics.

* load: any stb-supported format via PIL -> float32 HWC in [0,1]
  (reference: load_image_stb, src/additionally.c:3084-3110 — /255, no color shift)
* resize: darknet's separable bilinear with its exact endpoint rules — this is NOT
  PIL/OpenCV bilinear (no half-pixel centers): scale=(in-1)/(out-1), last column/row
  copies the source edge (reference: resize_image, src/additionally.c:3021-3064)
* save PNG, box drawing, class-color palette
  (reference: save_image_png src/additionally.c:3218; draw_box_width src/additionally.c:2982;
  get_color src/additionally.c:3247)

Arrays are HWC here (host side); the model consumes NHWC via ``to_batch``.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str, channels: int = 3) -> np.ndarray:
    """Load an image file -> float32 [H,W,C] in [0,1].

    Failure behavior matches the reference (load_image_stb,
    src/additionally.c:3084-3090): print ``Cannot load image "<path>"`` and
    the loader's reason to stderr, then exit(0) — a missing file reports
    stb's literal "can't fopen"."""
    import sys
    from PIL import Image
    try:
        img = Image.open(path)
        img.load()
    except FileNotFoundError:
        print(f'Cannot load image "{path}"\nSTB Reason: can\'t fopen',
              file=sys.stderr)
        raise SystemExit(0)
    except Exception as e:  # undecodable image: PIL's reason stands in for stb's
        print(f'Cannot load image "{path}"\nSTB Reason: {e}', file=sys.stderr)
        raise SystemExit(0)
    if channels == 3:
        img = img.convert("RGB")
    elif channels == 1:
        img = img.convert("L")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def resize_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Darknet-exact separable bilinear resize (reference: resize_image,
    src/additionally.c:3021-3064). ``im``: [H,W,C] float32 -> [h,w,C] float32.

    Endpoint rules: scale = (in_dim-1)/(out_dim-1); the last output column (and any
    output when in_w==1) copies the last input column; the last output row adds no
    second tap. Vectorized port of the scalar loops; float32 arithmetic throughout.
    """
    ih, iw = im.shape[:2]
    im = im.astype(np.float32)
    from ..native import resize_hwc_native
    native = resize_hwc_native(im, w, h)
    if native is not None:
        return native
    w_scale = np.float32((iw - 1) / (w - 1)) if w > 1 else np.float32(0)
    h_scale = np.float32((ih - 1) / (h - 1)) if h > 1 else np.float32(0)

    # horizontal pass -> part [ih, w, C]
    cols = np.arange(w, dtype=np.float32)
    sx = cols * w_scale
    ix = sx.astype(np.int32)
    dx = sx - ix
    ix1 = np.minimum(ix + 1, iw - 1)
    part = (1.0 - dx)[None, :, None] * im[:, ix, :] + dx[None, :, None] * im[:, ix1, :]
    edge = (cols == w - 1) | (iw == 1)
    if edge.any():
        part[:, edge, :] = im[:, iw - 1:iw, :]

    # vertical pass -> out [h, w, C]
    rows = np.arange(h, dtype=np.float32)
    sy = rows * h_scale
    iy = sy.astype(np.int32)
    dy = sy - iy
    out = (1.0 - dy)[:, None, None] * part[iy, :, :]
    second = ~((np.arange(h) == h - 1) | (ih == 1))
    iy1 = np.minimum(iy + 1, ih - 1)
    out[second] += dy[second, None, None] * part[iy1[second], :, :]
    return out.astype(np.float32)


def letterbox_image(im: np.ndarray, w: int, h: int) -> np.ndarray:
    """Aspect-preserving resize onto a 0.5-gray canvas (darknet letterbox_image;
    the reference app never calls it — kept for API completeness)."""
    ih, iw = im.shape[:2]
    if w / iw < h / ih:
        nw, nh = w, (ih * w) // iw
    else:
        nh, nw = h, (iw * h) // ih
    resized = resize_image(im, nw, nh)
    out = np.full((h, w, im.shape[2]), 0.5, np.float32)
    dy, dx = (h - nh) // 2, (w - nw) // 2
    out[dy:dy + nh, dx:dx + nw] = resized
    return out


def to_batch(im: np.ndarray) -> np.ndarray:
    """[H,W,C] -> [1,H,W,C] NHWC."""
    return im[None, ...]


def save_image_png(im: np.ndarray, path: str) -> None:
    """Save float image [H,W,C] in [0,1] as PNG (clipping like stb's cast)."""
    from PIL import Image
    arr = np.clip(im * 255.0, 0, 255).astype(np.uint8)
    if arr.shape[2] == 1:
        arr = arr[:, :, 0]
    Image.fromarray(arr).save(path if path.endswith(".png") else path + ".png")


def show_image_window(rgb_u8: np.ndarray, title: str) -> bool:
    """Display-gated interactive window (show_image/cvShowImage analog,
    src/additionally.c:3236-3245): with OpenCV AND a display, open ``title``
    and block on a keypress like cvWaitKey(0). Returns True iff shown, so
    callers can fall through to their headless branch. One shared helper for
    every window site (round-5 review: the block was duplicated in
    apps/detect.py and utils/distribution.py and had already drifted)."""
    import os
    if not (os.environ.get("DISPLAY") or os.name == "nt"):
        return False
    try:
        import cv2
        cv2.imshow(title, np.ascontiguousarray(rgb_u8[..., ::-1]))
        cv2.waitKey(0)
        cv2.destroyAllWindows()
        return True
    except Exception:
        return False


def get_color(c: int, x: int, max_val: int) -> float:
    """Class color palette (reference: get_color, src/additionally.c:3247-3256)."""
    colors = np.array([[1, 0, 1], [0, 0, 1], [0, 1, 1],
                       [0, 1, 0], [1, 1, 0], [1, 0, 0]], np.float32)
    ratio = (x / max_val) * 5
    i = int(np.floor(ratio))
    j = int(np.ceil(ratio))
    ratio -= i
    return float((1 - ratio) * colors[i][c] + ratio * colors[j][c])


def draw_box_width(im: np.ndarray, left: int, top: int, right: int, bot: int,
                   width: int, r: float, g: float, b: float) -> None:
    """Draw a box outline of given width in place (reference: draw_box_width,
    src/additionally.c:2982-2997)."""
    h, w = im.shape[:2]
    for off in range(width):
        l, t = left + off, top + off
        rr, bb = right - off, bot - off
        l = min(max(l, 0), w - 1)
        rr = min(max(rr, 0), w - 1)
        t = min(max(t, 0), h - 1)
        bb = min(max(bb, 0), h - 1)
        im[t, l:rr + 1] = (r, g, b)
        im[bb, l:rr + 1] = (r, g, b)
        im[t:bb + 1, l] = (r, g, b)
        im[t:bb + 1, rr] = (r, g, b)


def echo_detections_cv(dets, names, thresh: float, classes: int,
                       w: int, h: int, echo) -> None:
    """Print the demo's per-frame object lines exactly as the reference's
    draw_detections_cv_v3 printf's them from inside the draw (src/main.c:294,
    343-345): per detection, every class above thresh as ``name: P% `` on one
    line, then (when any class fired) the ext_output tab line with the
    CLAMPED-int corners and raw scaled w/h. Factored out of the draw so the
    demo can echo EVERY detected frame (the reference detects and prints every
    frame; only the DISPLAYED frame is delay-gated, main.c:553-557) without
    paying the pixel pass for frames it never shows. The reference loop runs
    over the POST-NMS qsort-permuted dets array — iterate that order."""
    from ..post.boxes import in_reference_order
    dets = in_reference_order(dets)
    for i in range(dets.n):
        class_id = -1
        for j in range(classes):
            if dets.prob[i, j] > thresh:
                if class_id < 0:
                    class_id = j
                print(f"{names[j]}: {dets.prob[i, j] * 100:.0f}% ",
                      end="", file=echo, flush=False)
        if class_id < 0:
            continue
        x, y, bw, bh = dets.bbox[i]
        left = max(int((x - bw / 2) * w), 0)
        top = max(int((y - bh / 2) * h), 0)
        print(f"\t(left_x: {float(left):4.0f}   top_y: {float(top):4.0f}"
              f"   width: {bw * w:4.0f}   height: {bh * h:4.0f})",
              file=echo)


def draw_detections_cv(im: np.ndarray, dets, names, thresh: float,
                       classes: int, echo=None) -> None:
    """Video-frame drawing with class-name label text per box, in place
    (reference: draw_detections_cv_v3, src/main.c:274-357).

    Per detection: labelstr comma-joins every class above thresh; the box color
    comes from the FIRST class above thresh (unlike the image path's best
    class); a filled label background spans (left, top-(10+25*font_size)) ..
    (right, top) with black text at (left, top-12), font_size = h/1000.
    Text rendering uses PIL's bitmap font instead of Hershey vectors.

    ``echo``: stream to print each ``name: P% `` as it is drawn — the
    reference printf's these from inside the draw (main.c:294), filling the
    demo's terminal UI under its "Objects:" header.
    """
    from PIL import Image, ImageDraw

    from ..post.boxes import in_reference_order
    dets = in_reference_order(dets)  # draw in the POST-NMS array order
    h, w = im.shape[:2]
    if echo is not None:
        # drawing prints nothing, so echoing all object lines up front is
        # byte-identical to the reference's interleaved printf's
        echo_detections_cv(dets, names, thresh, classes, w, h, echo)
    width = max(1, int(h * 0.006))  # reference truncates; floor 1 keeps boxes
    font_size = h / 1000.0          # visible on frames under ~170px tall
    overlays = []
    for i in range(dets.n):
        parts = []
        class_id = -1
        for j in range(classes):
            if dets.prob[i, j] > thresh:
                if class_id < 0:
                    class_id = j
                parts.append(names[j])
        if class_id < 0:
            continue
        offset = class_id * 123457 % classes
        rgb = (get_color(2, offset, classes), get_color(1, offset, classes),
               get_color(0, offset, classes))
        x, y, bw, bh = dets.bbox[i]
        left = max(int((x - bw / 2) * w), 0)
        right = min(int((x + bw / 2) * w), w - 1)
        top = max(int((y - bh / 2) * h), 0)
        bot = min(int((y + bh / 2) * h), h - 1)
        draw_box_width(im, left, top, right, bot, width, *rgb)
        bg_top = max(0, int(top - (10 + 25 * font_size)))
        im[bg_top:top + 1, left:right + 1] = rgb  # filled label background
        overlays.append((left, max(bg_top, top - 12), ", ".join(parts)))
    if overlays:
        pil = Image.fromarray((np.clip(im, 0.0, 1.0) * 255).astype(np.uint8))
        d = ImageDraw.Draw(pil)
        for tx, ty, s in overlays:
            d.text((tx, ty), s, fill=(0, 0, 0))
        im[:] = np.asarray(pil, dtype=np.float32) / 255.0


def draw_detections(im: np.ndarray, dets, names, thresh: float, classes: int) -> None:
    """Draw surviving detections on the image in place
    (reference: draw_detections_v3 image-output part, src/main.c:105-148).

    Boxes draw in ASCENDING best-class-probability order (the reference's
    compare_by_probs qsort, main.c:73-78,107) so the most confident box lands
    on top where outlines overlap — pixel-level predictions.png parity needs
    this layering. glibc's qsort is a stable mergesort, so equal-prob ties
    draw in the POST-NMS array order (post.in_reference_order)."""
    from ..post.boxes import in_reference_order
    dets = in_reference_order(dets)
    best_class = np.full(dets.n, -1)
    best_prob = np.full(dets.n, thresh, np.float32)
    for j in range(dets.prob.shape[1]):
        better = dets.prob[:, j] > best_prob
        best_class[better] = j
        best_prob[better] = dets.prob[better, j]
    h, w = im.shape[:2]
    width = max(1, int(h * 0.006))
    sel = np.nonzero(best_class >= 0)[0]
    for i in sel[np.argsort(best_prob[sel], kind="stable")]:
        offset = int(best_class[i]) * 123457 % classes
        rgb = (get_color(2, offset, classes), get_color(1, offset, classes),
               get_color(0, offset, classes))
        x, y, bw, bh = dets.bbox[i]
        left = int((x - bw / 2) * w)
        right = int((x + bw / 2) * w)
        top = int((y - bh / 2) * h)
        bot = int((y + bh / 2) * h)
        left, right = max(left, 0), min(right, w - 1)
        top, bot = max(top, 0), min(bot, h - 1)
        draw_box_width(im, left, top, right, bot, width, *rgb)
