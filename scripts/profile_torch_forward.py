"""Where the time of one port forward goes on the GPU.

Profiles warm b=1 forwards with the input already on the device, random
weights from ``--seed``: yolov3-416 (``tests/data/yolov3.cfg``) in int8
(``-quantized``, cpu policy; ``int8-fused`` adds ``-int8_impl fused``) and
fp32, and in the precision modes (``int8-gpu``: ``-int8_policy gpu``;
``int8-turbo``, ``int8-turbo_int8``, ``int8-turbo_int8-fused``,
``int8-bf16``, ``bf16``: the float convs on the bf16 conv kernel), and
tiny-yolo-obj_xnor-416
(``tests/data/tiny-yolo-obj_xnor.cfg``) in each ``-xnor_kernel`` engine
(``xnor-int8``, ``xnor-pallas``, ``xnor-pallas_mxu``, ``xnor-auto``) and
under ``-turbo`` with ``pallas_mxu`` (``xnor-pallas_mxu-turbo``), and
yolov2-voc-416 (``tests/data/yolov2-voc.cfg``) in ``-int8_policy cpu_old``
(``voc-int8-cpu_old``: the legacy all-int8 chain on K1's "old" epilogue),
``-quantized`` (``voc-int8``) and fp32 (``voc-fp32``). Prints
per mode: host wall time per forward (CUDA-synchronised,
profiler off), device busy time per forward (sum of GPU kernel and copy time
under ``torch.profiler``), their ratio, the device operations per forward,
the device time of the largest kernels, and the port's hand-written kernels
summed over their template instances. Needs one CUDA device.

Usage: ``python scripts/profile_torch_forward.py [--seed 7] [--iters 20]
[mode ...]`` (by default every mode).
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from yolo2_light_tpu_torch.apps.detect import build_params  # noqa: E402
from yolo2_light_tpu_torch.models.network import Predictor  # noqa: E402
from yolo2_light_tpu_torch.params import save_random_weights  # noqa: E402

CFG = os.path.join(ROOT, "tests", "data", "yolov3.cfg")
XNOR_CFG = os.path.join(ROOT, "tests", "data", "tiny-yolo-obj_xnor.cfg")
VOC_CFG = os.path.join(ROOT, "tests", "data", "yolov2-voc.cfg")

# name: (cfg, mode, Predictor keywords)
MODES = {"int8": (CFG, "int8", {}),
         "int8-fused": (CFG, "int8", {"int8_impl": "fused"}),
         "fp32": (CFG, "fp32", {}),
         "int8-gpu": (CFG, "int8", {"int8_policy": "gpu"}),
         "int8-turbo": (CFG, "int8", {"turbo": True}),
         "int8-turbo_int8": (CFG, "int8", {"turbo": "int8"}),
         "int8-turbo_int8-fused": (CFG, "int8", {"turbo": "int8",
                                                 "int8_impl": "fused"}),
         "int8-bf16": (CFG, "int8", {"compute_dtype": torch.bfloat16}),
         "bf16": (CFG, "fp32", {"compute_dtype": torch.bfloat16})}
MODES.update({f"xnor-{eng}": (XNOR_CFG, "fp32", {"xnor_impl": eng})
              for eng in ("int8", "pallas", "pallas_mxu", "auto")})
MODES["xnor-pallas_mxu-turbo"] = (XNOR_CFG, "fp32", {"xnor_impl": "pallas_mxu",
                                                     "turbo": True})
MODES.update({"voc-int8-cpu_old": (VOC_CFG, "int8", {"int8_policy": "cpu_old"}),
              "voc-int8": (VOC_CFG, "int8", {}),
              "voc-fp32": (VOC_CFG, "fp32", {})})
# the kernels of yolo2_light_tpu_torch/csrc, as the profiler names them
HAND_KERNELS = ("int8_conv_kernel", "fused_res_kernel", "xnor_popcount_kernel",
                "xnor_mma_kernel", "bf16_conv_kernel")


def profile_mode(weights: str, name: str, seed: int, iters: int,
                 top: int = 8) -> None:
    cfg, mode, kw = MODES[name]
    spec, params, _ = build_params(cfg, weights, quantized=mode == "int8",
                                   echo=False)
    pred = Predictor(spec, params, mode, device="cuda", **kw)
    x = torch.from_numpy(np.random.RandomState(seed).rand(
        1, spec.net.h, spec.net.w, spec.net.c).astype(np.float32)).cuda()
    for _ in range(5):
        pred(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pred(x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters * 1e3

    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            pred(x)
        torch.cuda.synchronize()
    per_kernel: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name][0] += e.self_device_time_total / 1e3 / n
            per_kernel[e.name][1] += 1
    busy = sum(v[0] for v in per_kernel.values())
    launches = sum(v[1] for v in per_kernel.values()) // n
    print(f"{name}: wall {wall:.3f} ms/forward (mean of {iters}, profiler "
          f"off); device busy {busy:.3f} ms/forward "
          f"({100 * busy / wall:.1f}% of wall); {launches} device "
          "operations/forward")
    for name, (ms, count) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:8.3f} ms  {100 * ms / busy:5.1f}%  x{count // n:4d}  "
              f"{name[:100]}")
    hand: dict = collections.defaultdict(lambda: [0.0, 0])
    for name, (ms, count) in per_kernel.items():
        for kernel in HAND_KERNELS:
            if f"::{kernel}" in name:
                hand[kernel][0] += ms
                hand[kernel][1] += count // n
    if hand:
        print("  hand kernels, all instances: " + ", ".join(
            f"{k} {ms:.3f} ms x{c}" for k, (ms, c) in hand.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("modes", nargs="*", help="modes to profile, of "
                    f"{', '.join(MODES)} (default: all)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.modes) - set(MODES))
    if unknown:
        ap.error(f"unknown modes {unknown}")
    modes = args.modes or list(MODES)
    if not torch.cuda.is_available():
        print("profile_torch_forward: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        weights = {}
        for cfg in {MODES[m][0] for m in modes}:
            weights[cfg] = os.path.join(tmp, os.path.basename(cfg) + ".w")
            save_random_weights(cfg, weights[cfg], seed=args.seed)
        for mode in modes:
            profile_mode(weights[MODES[mode][0]], mode, args.seed, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
