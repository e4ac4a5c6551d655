"""Single-image detection app (reference: test_detector_cpu, src/main.c:156-247).

Pipeline: parse cfg -> load weights -> fuse BN -> (quantize INT8) -> resize
image (darknet bilinear) -> forward on the device -> decode -> NMS -> print +
draw. Everything but the forward is NumPy host code, the port's copy of
the JAX package's (``cfg``, ``weights``, ``quant``, ``io``, ``post``).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np
import torch

from ..cfg import ConvSpec, SoftmaxSpec, parse_network_cfg
from ..io import image as im_io
from ..models.network import Predictor
from ..post import boxes as post
from ..quant import quantize_params
from ..weights import (fuse_conv_batchnorm, load_params_cache, load_weights,
                       random_params, save_params_cache)
from ..xnor import binarize_params


def build_params(cfgfile: str, weightfile, quantized: bool = False,
                 seed: int = 0, echo: bool = True, quant_banner: bool = False,
                 params_cache=None):
    """Init chain (reference: src/main.c:160-171 and :4552-4561):
    parse -> load/init -> BN-fuse -> XNOR-binarize -> (INT8-quantize), with
    the reference's construction-time prints when ``echo``; random params
    from ``seed`` when there is no ``weightfile``.

    ``params_cache``: a directory where the transformed params are kept as
    ``params_<key>.npz``, the JAX package's file under the JAX package's key
    (the SHA-1 of the weights' absolute path, mtime_ns and size,
    ``quantized`` and the SHA-1 of the cfg's bytes, cut to 16 hex digits):
    a later run with the same inputs skips load, fuse, binarize and
    quantize, and an edited cfg (new calibration scales, xnor flags) misses.
    """
    spec = parse_network_cfg(cfgfile, batch=1, quantized=quantized,
                             echo_table=echo)
    mode = "int8" if quantized else "fp32"
    cpath = None
    if params_cache and weightfile:
        cpath = params_cache_path(params_cache, cfgfile, weightfile,
                                  quantized)
        if os.path.exists(cpath):
            return spec, load_params_cache(cpath, spec.n), mode
    if weightfile:
        params = load_weights(spec, weightfile, verbose=echo)
    else:
        params = random_params(spec, seed=seed)
    params = fuse_conv_batchnorm(spec, params)
    params = binarize_params(spec, params)
    if quantized:
        if echo and quant_banner:
            print("\n\n Quantinization! \n")
        params = quantize_params(spec, params, echo=echo)
    if cpath:
        save_params_cache(params, cpath)
    return spec, params, mode


def params_cache_path(cache_dir: str, cfgfile: str, weightfile: str,
                      quantized: bool) -> str:
    """``<cache_dir>/params_<key>.npz`` under the JAX package's key
    (``yolo2_light_tpu/apps/detect.py`` build_params); makes the
    directory."""
    st = os.stat(weightfile)
    with open(cfgfile, "rb") as f:
        cfg_digest = hashlib.sha1(f.read()).hexdigest()
    key = hashlib.sha1(
        f"{os.path.abspath(weightfile)}:{st.st_mtime_ns}:{st.st_size}:"
        f"{quantized}:{cfg_digest}".encode()).hexdigest()[:16]
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"params_{key}.npz")


class _PipelinedAdapter:
    """Predictor-interface shim over ``parallel.pp.PipelinedPredictor``:
    heads-only ``__call__`` (the pipeline also returns its carried-state
    aux, which the apps never read)."""

    def __init__(self, ppred):
        self._pp = ppred
        self.spec = ppred.spec

    def __call__(self, x):
        heads, _aux = self._pp(x)
        return heads

    def head_specs(self):
        return self._pp.head_specs()


def build_predictor(cfgfile: str, weightfile, quantized: bool = False,
                    int8_policy: str = "cpu", int8_impl: str = "xla",
                    xnor_impl: str = "int8", device="cuda",
                    compute_dtype=None, turbo=False, params_cache=None,
                    pp_stages: int = 0, pp_tp: int = 1):
    """``compute_dtype``: None (float32) or torch.bfloat16 (``-bf16``);
    ``turbo``: False, True (``-turbo``) or "int8" (``-turbo_int8``);
    ``params_cache``: :func:`build_params`'. ``pp_stages > 1``: the forward
    runs as that many pipeline stages (``-pp``), each ``pp_tp`` positions
    wide (``-pp_tp``), on ``device``'s kind: ``cuda:0 ..`` (that many GPUs)
    or the CPU."""
    spec, params, mode = build_params(cfgfile, weightfile, quantized,
                                      quant_banner=True,
                                      params_cache=params_cache)
    cd = compute_dtype if compute_dtype is not None else torch.float32
    kw = dict(int8_policy=int8_policy, int8_impl=int8_impl,
              xnor_impl=xnor_impl, turbo=turbo, compute_dtype=cd)
    if pp_stages and pp_stages > 1:
        from ..parallel.pp import PipelinedPredictor
        pred = _PipelinedAdapter(PipelinedPredictor(
            spec, params, mode, n_stages=pp_stages, microbatch=1,
            tp=max(1, pp_tp), device=torch.device(device).type, **kw))
    else:
        pred = Predictor(spec, params, mode, device=device, **kw)
    return spec, pred


def forward_echo(spec) -> str:
    """The quantized forward's per-layer stdout block, one line per conv
    (reference: yolov2_forward_network_quantized.c:1039,1070)."""
    parts = []
    for l in spec.layers:
        if isinstance(l, ConvSpec):
            parts.append(f"\n {l.index} - CONVOLUTIONAL \t\t l.size = {l.size}  \n")
        elif isinstance(l, SoftmaxSpec):
            parts.append("\n layer: 4 \n")
    return "".join(parts)


def detect_image(pred, spec, filename: str, thresh: float, nms: float,
                 names, letter: bool = False, echo_layers: bool = False):
    """Run one image through the predictor; returns (dets, image, elapsed).
    ``elapsed`` covers the forward and the copy of the head maps to the host."""
    im = im_io.load_image(filename, 3)
    if letter:
        sized = im_io.letterbox_image(im, spec.net.w, spec.net.h)
    else:
        sized = im_io.resize_image(im, spec.net.w, spec.net.h)
    t0 = time.time()
    heads = pred(im_io.to_batch(sized))
    head_outputs = [h.data[0].cpu().numpy() for h in heads]
    elapsed = time.time() - t0
    if echo_layers:
        print(forward_echo(spec), end="")
    head_specs = pred.head_specs()
    dets = post.get_network_boxes(head_outputs, head_specs,
                                  im.shape[1], im.shape[0],
                                  spec.net.w, spec.net.h, thresh,
                                  relative=True, letter=letter)
    classes = head_specs[-1].classes if head_specs else 0
    if nms:
        post.do_nms_sort(dets, classes, nms)
    return dets, im, elapsed


def run(names, cfgfile: str, weightfile, filename, thresh: float = 0.24,
        quantized: bool = False, dont_show: bool = True,
        int8_policy: str = "cpu", save_path: str = "predictions",
        letter: bool = False, int8_impl: str = "xla", xnor_impl: str = "int8",
        device="cuda", compute_dtype=None, turbo=False,
        params_cache=None, pp_stages: int = 0, pp_tp: int = 1) -> str:
    """Single-image detect; with no filename, loops reading image paths from
    stdin (reference: test_detector_cpu while(1) fgets loop,
    src/main.c:176-186). Returns the last image's detection text."""
    spec, pred = build_predictor(cfgfile, weightfile, quantized,
                                 int8_policy=int8_policy, int8_impl=int8_impl,
                                 xnor_impl=xnor_impl, device=device,
                                 compute_dtype=compute_dtype, turbo=turbo,
                                 params_cache=params_cache,
                                 pp_stages=pp_stages, pp_tp=pp_tp)
    nms = 0.2 if quantized else 0.4  # reference: src/main.c:174,213
    head_specs = pred.head_specs()
    classes = head_specs[-1].classes if head_specs else 0
    text = ""
    while True:
        fname = filename
        if fname is None:
            print("Enter Image Path: ", end="", flush=True)
            line = sys.stdin.readline()
            if not line:
                return text
            fname = line.strip()
            if not fname:
                continue
        dets, im, elapsed = detect_image(pred, spec, fname, thresh, nms, names,
                                         letter=letter, echo_layers=quantized)
        print(f"{fname}: Predicted in {elapsed:f} seconds.")
        text = post.format_detections(dets, names, thresh, im.shape[1],
                                      im.shape[0])
        if text:
            print(text)
        im_io.draw_detections(im, dets, names, thresh, classes)
        im_io.save_image_png(im, save_path)
        if not dont_show:
            rgb = np.clip(im * 255.0, 0, 255).astype(np.uint8)
            if not im_io.show_image_window(rgb, "predictions"):
                print(f"Not compiled with OpenCV, saving to {save_path}.png "
                      "instead", file=sys.stderr)
                im_io.save_image_png(im, save_path)
        if filename is not None:
            return text
