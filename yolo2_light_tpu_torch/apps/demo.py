"""``detector demo``: video detection (reference: demo(), src/main.c:450-573).

Counterpart of ``yolo2_light_tpu/apps/demo.py``, with the same stdout. The
reference pipelines one fetch pthread against one detect pthread with
triple image buffering (src/main.c:490-572). Here a producer thread feeds
capture and resize into a bounded queue while batches of frames stream
through ``pipeline.DetectionPipeline.stream`` (depth 2): the host-to-device
copy, the captured CUDA graph of the device program, the copy back and the
host NMS overlap.

``frame_skip`` reproduces the reference's ``-s`` delay semantics
(src/main.c:453, 563-570): every frame is detected, but the displayed or
saved image and the FPS counter only advance every ``frame_skip + 1``
frames.

OpenCV is imported only where a codec, the window or the writer is needed:
``cv2.VideoCapture`` for a camera or a file that is not a CVSTUBV1 raw video
(``io/rawvideo.py``), ``imshow``/``waitKey`` unless ``dont_show``,
``VideoWriter`` for ``out_filename`` and ``imwrite`` for ``prefix``. A raw
video with ``dont_show`` and no ``prefix`` runs without OpenCV: the
BGR<->RGB conversions of uint8 frames are exact channel flips.
"""

from __future__ import annotations

import io as _io
import itertools
import queue
import sys
import threading
import time

import numpy as np
import torch

from ..io import image as im_io
from ..io.rawvideo import RawVideoCapture, is_rawvideo
from ..pipeline import DetectionPipeline
from .detect import build_params, forward_echo

# OpenCV's capture property ids (CAP_PROP_FRAME_WIDTH, _HEIGHT, _FPS)
_WIDTH, _HEIGHT, _FPS = 3, 4, 5


def _flip(frame: np.ndarray) -> np.ndarray:
    """BGR <-> RGB of a uint8 HxWx3 frame (cv2.cvtColor's result)."""
    return np.ascontiguousarray(frame[..., ::-1])


def _frames(cap, netw, neth, q, stop, uint8_ingest: bool,
            device_resize: bool):
    def offer(item) -> bool:
        # bounded put that re-checks stop, so an early-exiting consumer
        # cannot leave the producer blocked on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    while not stop.is_set():
        ok, frame = cap.read()
        if not ok:
            break
        rgb = _flip(frame)                    # uint8, source dims
        if device_resize:
            # the raw frame: /255 and the darknet bilinear run on the card
            sized = rgb if uint8_ingest else rgb.astype(np.float32) / 255.0
        else:
            sized = im_io.resize_image(rgb.astype(np.float32) / 255.0,
                                       netw, neth)
            if uint8_ingest:
                # uint8 frames: 4x fewer host-to-device bytes, at <= 1/510
                # per-pixel error from re-quantizing the resized frame
                # (the bf16 mode's default, as in the JAX demo)
                sized = (sized * 255.0 + 0.5).astype(np.uint8)
        if not offer((rgb, sized)):
            return
    offer(None)


def demo(cfgfile: str, weightfile, thresh: float, filename, names, *,
         quantized: bool = False, out_filename=None, dont_show: bool = True,
         cam_index: int = 0, int8_policy: str = "cpu", max_frames=None,
         compute_dtype=None, prefix=None, frame_skip: int = 0,
         batch: int = 0, params_cache=None, device_nms: bool = False,
         k: int = 256, uint8_ingest=None, turbo=False,
         int8_impl: str = "xla", device_resize: bool = False,
         device="cuda", pipeline_parallel: int = 0, pp_tp: int = 1) -> int:
    """Returns the number of frames processed. The float convs default to
    bfloat16 (``-bf16``, on the bf16 conv kernel); non-quantized frames then
    ship as uint8. ``compute_dtype=torch.float32`` (``-fp32``) is the
    reference-exact video path with float ingest. ``batch``: frames per
    device step (default 4 for a file, 1 for a camera).
    ``device_resize``: ship frames at source resolution and resize them on
    the card (uint8 ingest is then exact and on by default). ``device``:
    ``"cuda"`` (the default) or ``"cpu"`` (every kernel's plain version).
    ``pipeline_parallel`` and ``pp_tp`` (``-pp``, ``-pp_tp``): the pipeline's
    stages at microbatch 1, as in the JAX demo."""
    print("Demo", flush=True)  # main.c:456
    spec, params, mode = build_params(cfgfile, weightfile, quantized=quantized,
                                      params_cache=params_cache,
                                      quant_banner=True)  # main.c:467
    nms = 0.2 if quantized else 0.4
    # the reference's quantized forward prints a line per conv on every
    # frame (network_predict_quantized, from the detect thread); static per
    # net, so made once and printed per frame with the object lines
    conv_echo = forward_echo(spec) if quantized else ""
    cd = compute_dtype if compute_dtype is not None else torch.bfloat16
    pipe = DetectionPipeline(spec, params, mode, thresh=thresh, nms=nms,
                             int8_policy=int8_policy, k=k, compute_dtype=cd,
                             device_nms=device_nms, turbo=turbo,
                             int8_impl=int8_impl, device=device,
                             pp_stages=max(0, pipeline_parallel),
                             pp_tp=pp_tp, pp_microbatch=1)
    classes = pipe.classes
    if batch <= 0:
        batch = 4 if filename else 1

    if filename:
        print(f"video file: {filename}", flush=True)  # main.c:468-470
        # CVSTUBV1 raw-BGR streams (sniffed by magic) need no codec
        if is_rawvideo(filename):
            cap = RawVideoCapture(filename)
        else:
            import cv2
            cap = cv2.VideoCapture(filename)
    else:
        import cv2
        cap = cv2.VideoCapture(cam_index)
    if not cap.isOpened():
        # reference: error("Couldn't connect to webcam.\n"), main.c:476
        print("Couldn't connect to webcam.", file=sys.stderr)
        return 0

    writer = None
    if out_filename:
        import cv2
        fps_in = cap.get(_FPS) or 25
        writer = cv2.VideoWriter(out_filename,
                                 cv2.VideoWriter_fourcc(*"mp4v"), fps_in,
                                 (int(cap.get(_WIDTH)), int(cap.get(_HEIGHT))))
    gui = None
    if prefix or not dont_show:
        import cv2 as gui

    q: queue.Queue = queue.Queue(maxsize=2 * batch + 2)
    stop = threading.Event()
    # quantized runs keep float ingest (uint8 pre-rounding would perturb the
    # bit-exact int8 input quantization), unless the source bytes ship
    # unresized; -uint8_ingest / -no_uint8_ingest override
    if uint8_ingest is None:
        uint8_ingest = (True if device_resize
                        else cd == torch.bfloat16 and not quantized)
    t = threading.Thread(target=_frames,
                         args=(cap, spec.net.w, spec.net.h, q, stop,
                               uint8_ingest, device_resize), daemon=True)
    t.start()

    # rgb frames ride beside the device batches; stream() yields in
    # submission order and prefetches at most `depth` batches
    rgb_batches: list = []

    def pairs():
        """(stacked batch, padded im_sizes) tuples; the rgb frames go to
        rgb_batches for the result loop."""
        done = False
        while not done:
            rgbs, sizeds = [], []
            while len(sizeds) < batch:
                item = q.get()
                if item is None:
                    done = True
                    break
                rgbs.append(item[0])
                sizeds.append(item[1])
            if not sizeds:
                return
            rgb_batches.append(rgbs)
            szs = [(r.shape[1], r.shape[0]) for r in rgbs]
            while len(sizeds) < batch:
                # pad the tail batch to the batch size (one graph for the
                # whole stream); the extras are dropped by the rgb zip
                sizeds.append(sizeds[-1])
                szs.append(szs[-1])
            yield np.stack(sizeds), szs

    count = 0
    fps = 0.0
    delay = frame_skip
    before = time.time()
    stop_all = False
    last_bgr = None   # the reference's disp/show_img: the last drawn frame
    try:
        p1, p2 = itertools.tee(pairs())
        for dets_list in pipe.stream((b for b, _ in p1),
                                     im_sizes_iter=(s for _, s in p2),
                                     depth=2, workers=1):
            rgbs = rgb_batches.pop(0)
            for rgb, dets in zip(rgbs, dets_list):
                count += 1
                # every detected frame prints its object lines (main.c:294)
                buf = _io.StringIO()
                im_io.echo_detections_cv(dets, names, thresh, classes,
                                         rgb.shape[1], rgb.shape[0], buf)
                objects = buf.getvalue()
                # the delay gate (main.c:553-557): the drawn frame advances
                # when delay hits 0; the first frame primes it (main.c:496-504)
                if delay == 0 or last_bgr is None:
                    rgbf = rgb.astype(np.float32) / 255.0
                    im_io.draw_detections_cv(rgbf, dets, names, thresh,
                                             classes)
                    last_bgr = _flip(
                        (np.clip(rgbf, 0, 1) * 255).astype(np.uint8))
                    if writer is not None:
                        writer.write(last_bgr)
                    if not prefix and not dont_show:
                        gui.imshow("Demo", last_bgr)
                if prefix:
                    # -prefix saves every count, repeating the stale frame
                    # between advances (main.c:538-542)
                    gui.imwrite(f"{prefix}_{count:08d}.png", last_bgr)
                elif not dont_show:
                    if gui.waitKey(1) == 27:   # main.c:535
                        stop_all = True
                # screen clear + FPS + "Objects:" (main.c:431-435), header
                # first, then the objects: the JAX demo's order
                print(f"\033[2J\033[1;1H\nFPS:{fps:.1f}\nObjects:\n\n"
                      f"{conv_echo}{objects}", flush=True, end="")
                delay -= 1
                if delay < 0:
                    delay = frame_skip
                    after = time.time()
                    # displayed frames per second over the window
                    # (main.c:563-570)
                    fps = 1.0 / max(after - before, 1e-6)
                    before = after
                if max_frames is not None and count >= max_frames:
                    stop_all = True
                if stop_all:
                    break
            if stop_all:
                break
    finally:
        stop.set()
        t.join(timeout=2.0)   # the producer exits through its stop checks
        cap.release()
        if writer is not None:
            writer.release()
        if not dont_show:
            gui.destroyAllWindows()
    return count
