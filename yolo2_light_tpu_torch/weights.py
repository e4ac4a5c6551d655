# Mirrors yolo2_light_tpu/weights.py: a copy, so that the port imports
# nothing of the JAX package.
"""Darknet ``.weights`` binary reader and parameter transforms.

Format (reference: load_weights_upto_cpu, src/additionally.c:3491-3529):

* header: 3 x int32 ``major, minor, revision``; then ``seen`` — uint64 if
  ``major*10+minor >= 2`` else uint32.
* per CONVOLUTIONAL layer, in network order
  (reference: load_convolutional_weights_cpu, src/additionally.c:3459-3489):
  ``biases[n]`` f32; if batch_normalize: ``scales[n], rolling_mean[n],
  rolling_variance[n]`` f32; then ``weights[n*c*size*size]`` f32 (OIHW).

Parameters are kept as a list (one entry per network layer; non-conv layers get ``None``)
of dicts of numpy arrays. Conv weights are stored in HWIO layout (TPU/XLA-native for NHWC
convolutions); the OIHW->HWIO transpose happens once at load time.

Transforms:

* :func:`fuse_conv_batchnorm` — fold BN into weights/bias
  (reference math: yolov2_fuse_conv_batchnorm, src/additionally.c:67-109;
  epsilon 1e-6 is added to sqrt(var) OUTSIDE the sqrt).
* Writer :func:`save_weights` for round-trip tests and tooling.
"""

from __future__ import annotations

import struct
from typing import IO, Optional

import numpy as np

from .cfg import ConvSpec, ModelSpec


def _read_f32(f: IO[bytes], count: int) -> np.ndarray:
    data = np.fromfile(f, dtype=np.float32, count=count)
    if data.size != count:
        raise EOFError(f"weights file truncated: wanted {count} floats, got {data.size}")
    return data


def load_weights(spec: ModelSpec, path: str, cutoff: Optional[int] = None,
                 verbose: bool = False) -> list:
    """Read a darknet .weights file into a per-layer params list.

    Returns ``params`` where ``params[i]`` is ``None`` for non-conv layers and a dict
    with keys ``weights`` (HWIO f32), ``biases`` and, before fusion, optionally
    ``scales``/``rolling_mean``/``rolling_variance`` for BN layers.
    """
    if cutoff is None:
        cutoff = spec.n
    if verbose:
        # reference: fprintf(stderr, "Loading weights from %s...", ...) then
        # "Done!\n" after the read (src/additionally.c:3498,3527)
        import sys as _sys
        print(f"Loading weights from {path}...", end="", file=_sys.stderr,
              flush=True)
    params: list = [None] * spec.n
    with open(path, "rb") as f:
        major, minor, revision = struct.unpack("<3i", f.read(12))
        if major * 10 + minor >= 2:
            (seen,) = struct.unpack("<Q", f.read(8))
        else:
            (seen,) = struct.unpack("<I", f.read(4))
        init_weights = None  # lazily computed construction-time init (dontload)
        for i, l in enumerate(spec.layers):
            if i >= cutoff:
                break
            if not isinstance(l, ConvSpec):
                continue
            if l.dontload:
                # Reference skips the layer entirely (no bytes consumed,
                # src/additionally.c:3522) and keeps the construction-time
                # state: glibc-rand weights, zero biases, BN scales=1/mean=0/
                # var=0 (src/additionally.c:2746-2752,2797-2800).
                if init_weights is None:
                    from .utils.crand import darknet_conv_init
                    init_weights = darknet_conv_init(spec)
                entry = {"biases": np.zeros(l.n, np.float32),
                         "weights": init_weights[i]}
                if l.batch_normalize:
                    entry["scales"] = np.ones(l.n, np.float32)
                    entry["rolling_mean"] = np.zeros(l.n, np.float32)
                    entry["rolling_variance"] = np.zeros(l.n, np.float32)
                params[i] = entry
                continue
            entry = {"biases": _read_f32(f, l.n)}
            if l.batch_normalize:
                if l.dontloadscales:
                    # BN stats skipped, construction init kept
                    # (src/additionally.c:3463,2797-2800)
                    entry["scales"] = np.ones(l.n, np.float32)
                    entry["rolling_mean"] = np.zeros(l.n, np.float32)
                    entry["rolling_variance"] = np.zeros(l.n, np.float32)
                else:
                    entry["scales"] = _read_f32(f, l.n)
                    entry["rolling_mean"] = _read_f32(f, l.n)
                    entry["rolling_variance"] = _read_f32(f, l.n)
            w = _read_f32(f, l.n * l.c * l.size * l.size)
            # darknet OIHW -> HWIO
            entry["weights"] = np.transpose(
                w.reshape(l.n, l.c, l.size, l.size), (2, 3, 1, 0)).copy()
            params[i] = entry
    if verbose:
        import sys as _sys
        print("Done!", file=_sys.stderr)
    return params


def save_weights(spec: ModelSpec, params: list, path: str,
                 version=(0, 2, 0), seen: int = 0) -> None:
    """Write params back to the darknet binary format (HWIO -> OIHW)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", *version))
        major, minor, _ = version
        if major * 10 + minor >= 2:
            f.write(struct.pack("<Q", seen))
        else:
            f.write(struct.pack("<I", seen))
        for i, l in enumerate(spec.layers):
            if not isinstance(l, ConvSpec) or params[i] is None:
                continue
            if l.dontload:
                continue  # symmetric with load_weights: no bytes for this layer
            p = params[i]
            np.asarray(p["biases"], dtype=np.float32).tofile(f)
            if l.batch_normalize and not l.dontloadscales:
                np.asarray(p["scales"], dtype=np.float32).tofile(f)
                np.asarray(p["rolling_mean"], dtype=np.float32).tofile(f)
                np.asarray(p["rolling_variance"], dtype=np.float32).tofile(f)
            w = np.transpose(np.asarray(p["weights"], dtype=np.float32),
                             (3, 2, 0, 1))  # HWIO -> OIHW
            w.tofile(f)


def random_params(spec: ModelSpec, seed: int = 0, scale: Optional[float] = None) -> list:
    """Generate random conv params (for tests/benchmarks without real weights).

    Uses the reference's He-style init scale ``sqrt(2/(size*size*c))``
    (reference: make_convolutional_layer, src/additionally.c:2746-2747).
    """
    rng = np.random.RandomState(seed)
    params: list = [None] * spec.n
    for i, l in enumerate(spec.layers):
        if not isinstance(l, ConvSpec):
            continue
        s = np.sqrt(2.0 / (l.size * l.size * l.c)) if scale is None else scale
        entry = {
            "weights": (s * rng.uniform(-1, 1, (l.size, l.size, l.c, l.n))
                        ).astype(np.float32),
            "biases": rng.uniform(-0.5, 0.5, l.n).astype(np.float32),
        }
        if l.batch_normalize:
            entry["scales"] = rng.uniform(0.5, 1.5, l.n).astype(np.float32)
            entry["rolling_mean"] = rng.uniform(-0.3, 0.3, l.n).astype(np.float32)
            entry["rolling_variance"] = rng.uniform(0.2, 1.5, l.n).astype(np.float32)
        params[i] = entry
    return params


def fuse_conv_batchnorm(spec: ModelSpec, params: list) -> list:
    """Fold batchnorm into conv weights/biases, returning a new params list.

    Math (reference: yolov2_fuse_conv_batchnorm, src/additionally.c:80-88):
      denom = sqrt(rolling_variance) + 1e-6        (epsilon OUTSIDE the sqrt)
      bias' = bias - scales * rolling_mean / denom
      W'    = W * scales / denom                   (per output filter)
    """
    fused: list = []
    for i, l in enumerate(spec.layers):
        p = params[i]
        if p is None or not isinstance(l, ConvSpec) or "scales" not in p:
            fused.append(p)
            continue
        denom = np.sqrt(p["rolling_variance"]) + 1e-6
        factor = (p["scales"] / denom).astype(np.float32)
        fused.append({
            "biases": (p["biases"] - p["scales"] * p["rolling_mean"] / denom
                       ).astype(np.float32),
            "weights": (p["weights"] * factor[None, None, None, :]).astype(np.float32),
        })
    return fused


def is_fused(params: list) -> bool:
    return all(p is None or "scales" not in p for p in params)


# ---------------------------------------------------------------------------
# Converted-params cache (SURVEY §5 checkpoint/resume: the reference only ever
# reads .weights; we add an optional cache of the fused/quantized/binarized
# pytree so repeated runs skip parse+transform)
# ---------------------------------------------------------------------------


def save_params_cache(params: list, path: str) -> None:
    """Serialize a params list (with Nones) to one .npz file. ``path`` should end
    in .npz; it is appended otherwise (np.savez behavior), and load_params_cache
    applies the same rule so the pair always agrees."""
    flat = {}
    for i, p in enumerate(params):
        if p is None:
            continue
        for k, v in p.items():
            flat[f"{i}:{k}"] = np.asarray(v)
    np.savez(path, **flat)


def load_params_cache(path: str, n_layers: int) -> list:
    """Inverse of save_params_cache."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    params: list = [None] * n_layers
    with np.load(path) as z:
        for key in z.files:
            i_str, _, k = key.partition(":")
            i = int(i_str)
            if params[i] is None:
                params[i] = {}
            params[i][k] = z[key]
    return params
