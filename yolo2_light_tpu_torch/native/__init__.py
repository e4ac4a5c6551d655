# Mirrors yolo2_light_tpu/native/__init__.py: a copy, so that the port imports
# nothing of the JAX package.
"""Native (C++) runtime components: lazy g++ build + ctypes bindings.

The reference implements its runtime in C (box.c NMS, resize_image, pthread
loaders); the TPU build keeps the device compute in XLA/Pallas and the host-side hot
loops (NMS over candidates, darknet-exact resize) in C++. The shared library builds
on first use with g++ (cached under build/native/ of the checkout); every entry point has
a NumPy fallback so the framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["nms.cpp", "resize.cpp"]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)),
                          "build", "native")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build_and_load():
    src_text = "".join(open(os.path.join(_SRC_DIR, s)).read() for s in _SOURCES)
    tag = hashlib.sha256(src_text.encode()).hexdigest()[:16]
    cache = _BUILD_DIR
    os.makedirs(cache, exist_ok=True)
    so_path = os.path.join(cache, f"libyolo2native-{tag}.so")
    if not os.path.exists(so_path):
        # per-process temp name: concurrent cold-cache builds must not publish
        # each other's half-written output (os.replace is atomic)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp]
        cmd += [os.path.join(_SRC_DIR, s) for s in _SOURCES]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nms_sort.argtypes = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_float, i32p]
    lib.nms_sort.restype = None
    lib.box_iou_matrix.argtypes = [f32p, f32p, f32p, ctypes.c_int64,
                                   ctypes.c_int64]
    lib.box_iou_matrix.restype = None
    lib.resize_hwc.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, f32p, ctypes.c_int64,
                               ctypes.c_int64]
    lib.resize_hwc.restype = None
    return lib


def get_lib():
    """The native library, or None when unavailable (no g++ / build failure)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is None and not _lib_failed:
            try:
                _lib = _build_and_load()
            except Exception as e:
                _lib_failed = True
                print(f"yolo2_light_tpu_torch: native build unavailable ({e}); "
                      "using NumPy fallbacks", file=sys.stderr)
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def nms_sort_native(bbox: np.ndarray, prob: np.ndarray, objectness: np.ndarray,
                    thresh: float):
    """In-place per-class NMS on ``prob``. Returns the reference's POST-NMS
    array order (original det indices, int64) or None if the native lib is
    missing."""
    lib = get_lib()
    if lib is None:
        return None
    bbox = np.ascontiguousarray(bbox, np.float32)
    objectness = np.ascontiguousarray(objectness, np.float32)
    assert prob.flags["C_CONTIGUOUS"] and prob.dtype == np.float32
    order = np.empty(bbox.shape[0], np.int32)
    lib.nms_sort(_fptr(bbox), _fptr(prob), _fptr(objectness),
                 bbox.shape[0], prob.shape[1], ctypes.c_float(thresh),
                 order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return order.astype(np.int64)


def resize_hwc_native(im: np.ndarray, w: int, h: int):
    """Darknet-exact resize; returns the resized array or None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    im = np.ascontiguousarray(im, np.float32)
    out = np.empty((h, w, im.shape[2]), np.float32)
    lib.resize_hwc(_fptr(im), im.shape[0], im.shape[1], im.shape[2],
                   _fptr(out), h, w)
    return out
