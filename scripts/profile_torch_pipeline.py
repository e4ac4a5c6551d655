"""Where the device time of the port's serving pipeline goes on the GPU.

Runs ``pipeline.DetectionPipeline`` (device NMS, detector map's thresh 0.005,
nms 0.45 and K 1024) on 640x480 uint8 frames resized on the card, at b=1 and
b=8: each mode of ``chip_smoke.PIPE_MODES`` (yolov3-416 int8 ``xla`` and
``fused``, fp32 and the precision modes, tiny-yolo-obj_xnor-416
``pallas_mxu`` and ``pallas``). Random weights from
``--seed`` with the head objectness bias ``chip_smoke.calibrate_obj_bias``
picks per mode (about 300 live candidates a frame). Prints per mode and batch the device time of
one replay of the captured graph and of each stage run alone (ingest and
resize, the network, decode and top-K compaction, the NMS inputs: K7,
``nms_order``, with its plain PyTorch version beside it, and the
``nms_walk`` kernel), each
queued behind a device sleep so the host's dispatch is not timed, and the
largest kernels of the eager program under ``torch.profiler``. Needs one
CUDA device.

Usage: ``python scripts/profile_torch_pipeline.py [--seed 7] [--top 8]``
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from yolo2_light_tpu_torch import pipeline  # noqa: E402
from yolo2_light_tpu_torch.apps.detect import build_params  # noqa: E402
from yolo2_light_tpu_torch.ops.nms_order import (  # noqa: E402
    nms_order_cuda, nms_order_plain)
from yolo2_light_tpu_torch.ops.nms_walk import nms_walk  # noqa: E402


def device_ms(fn) -> float:
    """Device time of one call of ``fn``, behind a device sleep."""
    return cs.event_ms(fn, iters=1, warmup=2)


def profile_mode(name: str, seed: int, top: int) -> None:
    cfg, quantized, kw, _ = cs.PIPE_MODES[name]
    frames = cs._frames(seed, 8)
    bias = cs.calibrate_obj_bias(cfg, frames[0], quantized, kw)
    spec, params, mode = build_params(cfg, None, quantized=quantized,
                                      seed=seed, echo=False)
    cs.sparse_head_biases(spec, params, bias)
    pipe = pipeline.DetectionPipeline(
        spec, params, mode, thresh=cs.PIPE_THRESH, nms=cs.PIPE_NMS,
        k=cs.PIPE_K, device_nms=True, device="cuda", **kw)
    for b in (1, 8):
        x = torch.from_numpy(frames[:b]).cuda()
        with torch.inference_mode():
            pipe.raw(x)
            g = pipe._graphs[(tuple(x.shape), torch.uint8, False)]
            xin = pipe.ingest(x)
            heads = [h.data for h in pipe._fwd(pipe.params, xin)[0]]
            packed = pipe._decoder.packed(heads)
            boxes, probs = packed[..., :4], packed[..., 5:]
            ins = nms_order_cuda(boxes, probs, cs.PIPE_NMS)
            live = int((ins[2] > 0).sum(1).max())
            stages = {
                "graph replay": device_ms(g.graph.replay),
                "ingest": device_ms(lambda: pipe.ingest(x)),
                "network": device_ms(lambda: pipe._fwd(pipe.params, xin)),
                "decode": device_ms(lambda: pipe._decoder.packed(heads)),
                "nms inputs": device_ms(lambda: nms_order_cuda(
                    boxes, probs, cs.PIPE_NMS)),
                "nms inputs plain": device_ms(lambda: nms_order_plain(
                    boxes, probs, cs.PIPE_NMS)),
                "nms_walk": device_ms(lambda: nms_walk(*ins[:3], probs)),
            }
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pipe.run(x)
                torch.cuda.synchronize()
        per_kernel: dict = collections.defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_kernel[e.name][0] += e.self_device_time_total / 1e3
                per_kernel[e.name][1] += 1
        busy = sum(v[0] for v in per_kernel.values())
        ops = sum(v[1] for v in per_kernel.values())
        print(f"{name} b={b}: " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in stages.items())
            + f" (live ranks {live}); eager program under the profiler: "
            f"{busy:.3f} ms in {ops} device operations", flush=True)
        for kname, (ms, count) in sorted(per_kernel.items(),
                                         key=lambda kv: -kv[1][0])[:top]:
            print(f"  {ms:8.3f} ms  {100 * ms / busy:5.1f}%  x{count:4d}  "
                  f"{kname[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_pipeline: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for name in cs.PIPE_MODES:
        profile_mode(name, args.seed, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
