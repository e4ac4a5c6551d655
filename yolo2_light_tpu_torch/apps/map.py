"""``detector map`` app (reference: validate_detector_map,
src/additionally.c:4541).

Counterpart of ``yolo2_light_tpu/apps/map.py``. Images are decoded and
resized on the host by a thread pool (the analog of the reference's 4
pthread loaders, src/additionally.c:4584-4628) into device batches; the
DetectionPipeline runs each batch as one CUDA graph; matching and AP
accounting run on the host in eval/map.py. One batch is in flight while the
next one loads (``dispatch``/``collect``); batches are accounted in order,
so the printed report is the serial one's.

``data_parallel``, ``tensor_parallel`` and ``spatial_parallel`` (``-parallel``,
``-tp``, ``-sp``) run the pipeline on a ``parallel.mesh`` of dp*sp*tp
positions, ``pipeline_parallel`` and ``pp_tp`` (``-pp``, ``-pp_tp``) as
pipeline stages, as the JAX package's map does: the batch is raised to the
data axis and cut to a multiple of it, and a tail batch is padded with zero
images whose detections are dropped.
"""

from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..datacfg import load_names, read_data_cfg
from ..eval.map import (MapAccumulator, format_map_report, label_path_for,
                        read_truth_boxes)
from ..io import image as im_io
from ..pipeline import DetectionPipeline
from .detect import build_params


def _load_one(path, netw, neth):
    im = im_io.load_image(path, 3)
    return im_io.resize_image(im, netw, neth)


def validate_detector_map(datacfg: str, cfgfile: str, weightfile, *,
                          thresh: float = 0.25, quantized: bool = False,
                          iou_thresh: float = 0.5, int8_policy: str = "cpu",
                          batch: int = 8, nthreads: int = 4, k: int = 1024,
                          device_nms: bool = False, int8_impl: str = "xla",
                          device="cuda", compute_dtype=None,
                          turbo=False, data_parallel: int = 0,
                          tensor_parallel: int = 0,
                          spatial_parallel: int = 0,
                          pipeline_parallel: int = 0, pp_tp: int = 1,
                          params_cache=None) -> dict:
    options = read_data_cfg(datacfg)
    valid_images = options.get("valid", "data/train.txt")
    difficult_images = options.get("difficult")
    names = load_names(options.get("names", "data/names.list"))
    # .data map= is read (and ignored) exactly like the reference
    # (src/additionally.c:4549-4550 reads it, then passes map=0 at :4664)
    options.get("map")

    spec, params, mode = build_params(cfgfile, weightfile, quantized=quantized,
                                      params_cache=params_cache)
    mesh = None
    dp = max(1, data_parallel)
    tp = max(1, tensor_parallel)
    sp = max(1, spatial_parallel)
    if dp * tp * sp > 1:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(dp * sp * tp, data=dp, model=tp, space=sp,
                         device=torch.device(device).type)
        batch = max(batch, dp)
        batch -= batch % dp  # keep shards even
    pp = max(0, pipeline_parallel)
    pipe = DetectionPipeline(spec, params, mode, thresh=0.005, nms=0.45, k=k,
                             int8_policy=int8_policy, device_nms=device_nms,
                             int8_impl=int8_impl, device=device, turbo=turbo,
                             compute_dtype=(compute_dtype
                                            if compute_dtype is not None
                                            else torch.float32),
                             mesh=mesh, pp_stages=pp, pp_tp=pp_tp,
                             pp_microbatch=max(1, batch // max(1, pp)))
    classes = pipe.classes

    with open(valid_images) as f:
        paths = [l.strip() for l in f if l.strip()]
    dif_paths = None
    if difficult_images:
        with open(difficult_images) as f:
            dif_paths = [l.strip() for l in f if l.strip()]

    acc = MapAccumulator(classes=classes, iou_thresh=iou_thresh,
                         thresh_calc_avg_iou=thresh)
    start = time.time()
    netw, neth = spec.net.w, spec.net.h

    def account(i, j, dets_list):
        for t, dets in zip(range(i, j), dets_list):
            if (t + 1) % 4 == 0 or t + 1 == len(paths):
                # stderr progress at the reference's nthreads=4 cadence
                # (fprintf(stderr, "%d\n", i), additionally.c:4612)
                print(f"{(t + 1 + 3) // 4 * 4}", file=sys.stderr)
            truth = read_truth_boxes(label_path_for(paths[t]))
            truth_dif = None
            if dif_paths is not None and t < len(dif_paths):
                truth_dif = read_truth_boxes(label_path_for(dif_paths[t]))
            acc.add_image(dets, truth, truth_dif)

    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        # the pool decodes the images of a batch in parallel; the next batch
        # loads while the device runs the one dispatched before it
        inflight = None
        i = 0
        while i < len(paths) or inflight is not None:
            nxt = None
            if i < len(paths):
                j = min(i + batch, len(paths))
                imgs = np.stack(list(pool.map(
                    lambda p: _load_one(p, netw, neth), paths[i:j])))
                if imgs.shape[0] % pipe.data_parallel:
                    # pad the tail batch to a shardable size; the padding's
                    # detections are dropped in account()
                    pad = (pipe.data_parallel
                           - imgs.shape[0] % pipe.data_parallel)
                    imgs = np.concatenate(
                        [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
                nxt = (pipe.dispatch(imgs), i, j)
                i = j
            if inflight is not None:
                ticket, a, b = inflight
                account(a, b, pipe.collect(ticket))
            inflight = nxt

    result = acc.compute()
    print(format_map_report(result, names, iou_thresh, thresh))
    print(f"Total Detection Time: {time.time() - start:f} Seconds",
          file=sys.stderr)
    return result
