"""Profiling and tracing.

Counterpart of ``yolo2_light_tpu/utils/profiling.py``. The reference's
observability is ad hoc (wall-clock prints around predict,
src/main.c:197-220; per-layer BFLOPs at construction,
src/additionally.c:2903-2907). Here:

* :func:`layer_cost_table`: the static per-layer BFLOPs / params /
  activation-bytes table, the JAX package's text;
* :func:`profile_layers`: measured cumulative time after each layer of one
  eager forward, from CUDA events recorded between the layers on the card
  (the forward queued behind a device sleep, so they time its kernels and
  not the host's dispatch) and from the wall clock on the CPU;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``) into a directory (``-profile DIR``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..cfg import ConvSpec, ModelSpec

_SLEEP_HZ = 2.0e9       # device-sleep cycles per second, at least


def layer_cost_table(spec: ModelSpec) -> str:
    """Static cost table: BFLOPs, params, output activation MB per layer."""
    lines = ["idx  type            BFLOPs    params     out-MB"]
    total_bf = 0.0
    total_p = 0
    for l in spec.layers:
        name = type(l).__name__.replace("Spec", "").lower()
        bf = l.bflops if isinstance(l, ConvSpec) else 0.0
        par = (l.n * l.c * l.size * l.size + l.n) if isinstance(l, ConvSpec) else 0
        out_mb = l.outputs * 4 / 1e6
        total_bf += bf
        total_p += par
        lines.append(f"{l.index:3d}  {name:12s} {bf:9.3f} {par:9d} {out_mb:9.2f}")
    lines.append(f"total {total_bf:.3f} BFLOPs, {total_p / 1e6:.1f}M params")
    return "\n".join(lines)


def profile_layers(spec: ModelSpec, params: list, x, *, iters: int = 3,
                   mode: str = "fp32", compute_dtype=None,
                   device="cuda") -> list:
    """Measured cumulative time after each layer of the eager forward.

    Returns ``[(index, layer_name, cumulative_ms, delta_ms)]``, the JAX
    function's rows: the mean over ``iters`` forwards (after warm-up) of
    the time from the forward's start to the end of layer ``index``, and its
    difference to the previous layer's (clamped at 0). ``params``: the host
    params of ``apps/detect.build_params``. On a CUDA ``device`` each layer
    is bracketed by CUDA events on the current stream, and each forward is
    queued behind a device sleep twice as long as one synchronised forward
    takes on the host clock: the host has issued the whole forward before
    the card starts it, so the events time the layers' kernels back to back
    (device time, without the gaps where the card would wait for the
    host). On the CPU the rows are the wall clock.
    """
    from ..models.network import build_forward, device_params, load_kernels

    dev = torch.device(device)
    cd = compute_dtype if compute_dtype is not None else torch.float32
    cuda = dev.type == "cuda"
    marks: dict = {}

    def mark(i: int) -> None:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[i] = ev
        else:
            marks[i] = time.perf_counter()

    fwd = build_forward(spec, mode, compute_dtype=cd, layer_hook=mark)
    dev_params = device_params(spec, params, mode, dev, compute_dtype=cd)
    if cuda:
        load_kernels(spec, mode, compute_dtype=cd)
    xd = torch.as_tensor(x).to(dev, torch.float32)
    cum = [0.0] * spec.n
    with torch.inference_mode():
        fwd(dev_params, xd)              # warm-up: kernels, caches, cuDNN
        if cuda:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fwd(dev_params, xd)
            torch.cuda.synchronize(dev)
            # cycles at the card's top clock (under 2 GHz on an H100)
            sleep = int(2 * (time.perf_counter() - t0) * _SLEEP_HZ)
        for _ in range(iters):
            marks.clear()
            if cuda:
                torch.cuda._sleep(sleep)
            mark(-1)
            fwd(dev_params, xd)
            if cuda:
                torch.cuda.synchronize(dev)
            for i in range(spec.n):
                cum[i] += (marks[-1].elapsed_time(marks[i]) if cuda
                           else (marks[i] - marks[-1]) * 1e3)
    results = []
    prev = 0.0
    for i, l in enumerate(spec.layers):
        c = cum[i] / iters
        results.append((i, type(l).__name__.replace("Spec", ""), c,
                        max(0.0, c - prev)))
        prev = c
    return results


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the CPU and, where there is a card, the
    CUDA activity inside the block, written to ``<log_dir>/trace.json``
    (Chrome trace format: chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
