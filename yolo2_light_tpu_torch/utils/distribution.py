# Mirrors yolo2_light_tpu/utils/distribution.py: a copy, so that the port
# imports nothing of the JAX package.
"""Weight/activation distribution visualization for quantization debugging.

Reference: draw_distribution (src/yolov2_forward_network_quantized.c:96-169) draws a
log2-count histogram over the 32 doubling ranges [1/65536 * 2^j, ...) with a marker
line at the optimal INT8 multiplier, in an OpenCV window. This version renders the
same bars/marker to a PNG (headless-friendly) via PIL.
"""

from __future__ import annotations

import numpy as np

from ..quant import get_distribution, get_multiplier


def draw_distribution(arr: np.ndarray, name: str | None = None,
                      out_path: str = "distribution.png",
                      img_w: int = 1200, img_h: int = 800,
                      show: bool = False) -> float:
    """Render the distribution histogram; returns the optimal multiplier.

    With show=True (and OpenCV + a display available) additionally opens the
    reference's interactive "Distribution" window and blocks on a keypress
    (cvShowImage/cvWaitKey(0), src/yolov2_forward_network_quantized.c:164-165);
    headless hosts fall back to the PNG silently.
    """
    from PIL import Image, ImageDraw
    number_of_ranges = 32
    start_range = 1.0 / 65536
    count = get_distribution(arr, number_of_ranges, start_range).astype(np.float64)
    multiplier = get_multiplier(arr, 8)

    # log2 bars like the reference's count[j] = log2(count[j]) int truncation;
    # its log2(0) -> -inf int cast yields an off-image (clipped) rectangle, so
    # empty ranges draw nothing — clamp to a 0-height bar for the same pixels
    with np.errstate(divide="ignore"):
        bars = np.log2(np.maximum(count, 1)).astype(int)
    max_count = int(bars.max())

    img = Image.new("RGB", (img_w, img_h), (0, 0, 0))
    d = ImageDraw.Draw(img)
    if max_count > 0:  # reference skips all bars when every range is empty
        for j in range(number_of_ranges):
            x1 = j * img_w // number_of_ranges
            x2 = (j + 1) * img_w // number_of_ranges
            y2 = img_h - img_h * int(bars[j]) // max_count
            d.rectangle([x1, min(img_h, y2), x2, img_h], fill=(128, 64, 32),
                        outline=(32, 32, 32))
    index_multiplier = int(np.log2(1.0 / (multiplier * start_range)))
    x = index_multiplier * img_w // number_of_ranges
    d.line([(x, 0), (x, img_h)], fill=(255, 32, 32), width=1)
    # reference text: title at (100,50), name at (0,20), axis labels at
    # img_h-50, all CV_RGB(32,64,128) (no Hershey font in PIL — glyphs are a
    # documented approximation; geometry above is the pinned part)
    d.text((100, 50), f"optimal multiplier = {multiplier:g}",
           fill=(32, 64, 128))
    if name:
        d.text((0, 20), name, fill=(32, 64, 128))
    cur = start_range
    for j in range(number_of_ranges):
        d.text((j * img_w // number_of_ranges, img_h - 50),
               str(int(np.log2(cur))), fill=(32, 64, 128))
        cur *= 2
    d.text((img_w // 2 - 100, img_h - 10), "X and Y are log2",
           fill=(32, 64, 128))
    img.save(out_path)
    if show:
        from ..io.image import show_image_window
        show_image_window(np.asarray(img), "Distribution")
    return multiplier
