"""Chip check of the PyTorch/CUDA port (yolo2_light_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them.
2. build: compiles the eight kernels of ``yolo2_light_tpu_torch/csrc``, one
   nvcc per source, all started together (each build and the phase timed).
3. kernels: the int8 conv kernel in both input forms (f32 input quantized
   in its loader, the network's path; pre-quantized int8 input, the Pallas
   signatures') against its plain PyTorch version on the card at yolov3-416's
   15 int8 conv shape classes (1x1, 3x3/s1 and 3x3/s2 at each output size
   from 13 to 208), with the split of K across a cluster the planner gives
   each; outputs must be bit-identical. Times each form, the plain version
   and, as a yardstick never on the port's path, ``torch._int_mm`` on the
   same [P, ks*ks*C] x [ks*ks*C, M] int8 product (no gather, no epilogue),
   each beside the least time the card could take (bytes or operations).
4. int8: ``detector test ... -quantized`` through the CLI on yolov3-416 with
   random weights (seed 7); the kernel's launch count must rise by the size
   of the int8 set in that one forward, with no separate quantize launch and
   no input copy in front of any of them. The same forward with the plain
   versions on the card must give equal head maps and identical detection
   lines. Times the warm b=1 forward.
5. fused: the fused residual-block kernel against its plain version at
   yolov3-416's five residual-block shapes (b1 > 0) and on a chain of two
   blocks at 104x104; bit-identical. Times the kernel, the unfused pair of
   int8 conv launches and its add, and the plain version, and prints the
   launch at each shape: cluster size, blocks, dynamic shared memory per
   block, ring depths, and how many clusters the card holds at once
   (``cudaOccupancyMaxActiveClusters``, through ``fused_res.occupancy``).
   Then ``detector test ... -quantized -int8_impl fused`` through the CLI:
   one forward must launch the fused kernel 23 times and the int8 conv
   kernel 25 times; its head maps must equal those of the int8 conv path
   and of the plain path, and its detection lines those of the int8 conv
   path. Times the warm b=1 forward of both kernel paths.
6. fp32: the same ``detector test`` without ``-quantized`` (TF32 off), its
   heads checked finite, and the port's card and CPU paths held to each
   other on a small net. Times the warm b=1 forward.
7. xnor: the popcount kernel (K3) and the binary tensor-core kernel (K4)
   against their plain versions, and the dense +-1 engine against both, bit
   for bit, leaky and linear, at tiny-yolo-obj_xnor-416's seven XNOR conv
   shapes (b=1), printing each kernel's launch plan (``xnor_gemm.plan_launch``:
   tile, K step, ring depth, cluster split, blocks). Times each kernel, each
   conv-level engine (input packing included), the plain versions and, as a
   yardstick never on the port's path, ``torch._int_mm`` on the +-1 int8
   product [P, 9*C32*32] x [9*C32*32, M] (patches gathered and unpacked
   beforehand, no epilogue); prints K3's share of its popcount floor (16
   popcounts an SM a clock). Then ``detector test`` through the CLI
   on ``tests/data/tiny-yolo-obj_xnor.cfg`` with random weights (seed 7)
   for each ``-xnor_kernel`` value: one forward must launch K3 7 times for
   ``pallas``, K4 7 times for ``pallas_mxu``, neither for ``int8``, and K4
   at the convs ``auto``'s rule gives it; the four engines and the plain
   versions on the card must give equal head maps and identical detection
   lines. Times the warm b=1 forward of each engine.
8. pipeline: the device NMS's two kernels, K7 (``csrc/nms_order.cu``: the
   overlap bits, the carried argsort chain, rank_has_work) and the rank walk
   (``csrc/nms_walk.cu``), against their plain versions, bit for bit, at
   B=8, C=80 and K = 256, 1024 and 4096 and at C = 20 (B = 8 and 1, K =
   1024), on views of a packed buffer of clustered candidates with
   exact-prob ties, each timed beside its bound and its plain version; the
   peak device memory of one ``nms_packed`` at B=8, K=4096, kernels against
   plain versions. Then the
   serving pipeline (``pipeline.DetectionPipeline``, device NMS on) on
   yolov3-416 int8 (``xla`` and ``fused``) and fp32 and on
   tiny-yolo-obj_xnor-416 ``pallas_mxu`` and ``pallas``, from 640x480 uint8
   frames resized on the card, at b=1 and b=8, and yolov3-416 in phase 9's
   precision modes (``-int8_policy gpu``, ``-turbo``, ``-turbo_int8``,
   ``-quantized -bf16``, ``-bf16``): each replay of the captured CUDA graph must
   equal the eager program bit for bit, the hand kernels of the mode must
   launch inside the capture, and ``serve_scan`` over the 8-frame ring must
   equal the per-frame calls. For yolov3-416 int8 and tiny-yolo-obj_xnor-416
   ``pallas_mxu`` at b=1 and b=8, the NMS stage on the decode's own packed
   buffer: K7, the walk and ``nms_packed`` timed, K7's plain version (the
   PyTorch ops it replaced) beside them; after the last phase, the
   stage's device operations under torch.profiler in a process of its own,
   and no sort in it (profiler sessions in this process lost kernels after
   a few). The detections of 8 frames at the net's size
   (b=8) must print the lines ``detect_image`` (eager forward, host decode
   and NMS) prints for the same frames as PNGs, as multisets; a line may
   differ only by one print count in a box field, in at most 1% of the lines
   (F7: CUDA's expf against the host's; the print's sort by left edge may
   then swap two boxes with near-equal left edges); under ``-bf16`` each
   frame of the b=8 batch must also print the lines it prints alone (K6's
   batch invariance). Random weights (seed 7) with
   ``sparse_head_biases`` (a copy of bench.py's) at a head objectness bias
   the script calibrates per mode so that about 300 candidates of a frame
   pass detector map's thresh 0.005. Prints each mode's wall per batch, captured
   and eager (median, host clock, uint8 frames in and the packed buffer
   out), the device time of the same program queued behind a device sleep,
   and the share of the wall the device idles. Last, ``detector map
   -quantized`` through the CLI on yolov3-416 over 16 synthetic PNGs with
   labels, host NMS and ``-device_nms -k 64`` (auto-grow): identical report
   blocks; prints the live candidate counts, the K auto-grow reached and
   the img/s of each run.
9. precision: K1's new forms (``<input>/<semantics>/<store>``: the bf16
   input form, the gpu epilogue, the bf16 and int8 stores) against their
   plain twins, bit for bit, leaky and linear, at yolov3-416's 15 int8 conv
   classes (the gpu epilogue at the gpu set's 6: 3x3/s1 and the first
   3x3/s2); the forms the precision modes launch timed beside their bounds
   (bytes at the form's widths) and ``torch._int_mm``. Then ``detector test``
   through the CLI on yolov3-416 (random weights, seed 7) with
   ``-quantized -int8_policy gpu`` (26 ``int8_conv`` launches a forward),
   ``-quantized -turbo`` (71, with no quantize launch or input copy in
   front: K1 reads and stores bf16), ``-quantized -turbo_int8`` (71),
   ``-quantized -turbo_int8 -int8_impl fused`` (23 ``fused_res_block`` and 25
   ``int8_conv``), ``-quantized -bf16`` (71, and 4 of K6) and ``-bf16`` (75
   of K6), and on tiny-yolo-obj_xnor-416 with ``-turbo -xnor_kernel
   pallas_mxu`` (7 K4): head maps and detection lines of the kernel path
   equal those of the plain path on the card (``fused_plain`` for the fused
   engine, whose runs keep a float32 interior under ``-turbo_int8``; under
   ``-bf16`` the plain path runs K6's plain twin, whose float32 sums differ
   in order: heads and lines held at limits set from a sound run's readings,
   ``check_bf16_heads`` and ``check_bf16_lines``; under ``-quantized -bf16``
   both sides run K6, so K1 is held bit for bit); warm b=1 forwards.
10. cpu_old and calibrate, on yolov2-voc-416 (``tests/data/yolov2-voc.cfg``,
   random weights, seed 7, b=1, nothing cut): K1's "old" epilogue
   (``-int8_policy cpu_old``, int8 input) against its plain twin, bit for
   bit, in its float32, int8 and dual stores, leaky and linear, at
   yolov2-voc's 12 int8 conv classes; the store the path launches at each
   class timed beside its bound and ``torch._int_mm``. Then ``detector test
   -quantized -int8_policy cpu_old`` through the CLI: one forward launches
   K1 at every conv from 1 up to the linear head (21: 20 in
   ``int8/old/int8``, 1 in ``int8/old/f32``), heads and detection lines of
   the kernel path equal the plain path's; warm wall and device busy.
   ``DetectionPipeline`` in cpu_old at b=1: graph replay == eager, K1's old
   form launched in the capture, captured walls and device time. Last,
   ``detector calibrate -calib_method device`` through the CLI over 8
   synthetic PNGs: 23 finite positive multipliers written and parsed back
   by the port's cfg; over the first 2 images the device method's saved
   multipliers are within 0.02 of the host method's on the same card
   activations, each image's multiplier of each conv lands on the host's
   threshold bin or a neighbour, and each method's ms per image after its
   set-up is printed.
11. bf16, demo, tree, profile. K6 (``csrc/bf16_conv.cu``, -bf16's float
   convs: bfloat16 operands, float32 sums split across a cluster and
   combined in rank order, bias and leaky in its store) against its
   plain twin (the float32 conv of the same bfloat16 operands, TF32 off,
   cuDNN deterministic) at each of yolov3-416's 23 conv shapes (the first
   is yolov2-voc-416's first conv too) at b=1 and b=8: the plan (form,
   slab width, split) the same at both, every output within K * 2**-23 *
   sum |x * w| (K = ks*ks*C, the float32-accumulate bound of two orders of
   the same sum), every image of the b=8 result bit-identical to that
   image alone at b=1, and bias and leaky in the store bit-equal to the
   bare conv followed by the unfused chain (``epilogue_plain``); timed at
   b=1 with its epilogue beside its bare conv, its
   bound, the plain twin, cuDNN's bfloat16 conv (``library_ms``) and
   cuDNN's float32 conv of the bfloat16 operands. ``detector test -bf16``
   through the CLI on yolov3-416: 75 K6 launches a forward (``-quantized -bf16``: 4
   beside K1's 71), the first conv in the c3 form and every conv whose
   input is 13x13 or 26x26 splitting K; one forward of each under
   torch.profiler (K6's device time and launches, device busy and
   operations; under -bf16 no bias or leaky op, ``aten::add`` only at the
   23 shortcuts, and no op of an unfused BN); each of the
   forward's convs within the bound on the input the forward gives it,
   the heads near the plain path's (``check_bf16_heads``), and at b=8
   every image's heads bit-identical and its lines equal to its b=1
   ones. ``detector demo`` through the CLI on a
   24-frame 640x480 raw video written from numpy (yolov3-416, head biases made
   sparse as in phase 8, about 30 candidates a frame above the CLI's
   default thresh 0.25) in the default bf16 mode, ``-fp32`` and
   ``-quantized``, with no OpenCV imported: every frame, each frame's object
   lines those of the same pipeline on the same frames (``check_near_lines``);
   then the demo's frames per second over a 256-frame video, with their
   spread over the run's quarters. The mini YOLO9000 tree net of
   tests/test_tree.py through ``detector test -quantized`` and the pipeline:
   kernel path equal to the plain path, pipeline equal to ``detect_image``.
   ``detector test -bf16 -profile DIR`` leaves a trace with K6's launches,
   ``-i 0`` prints the same lines, and ``utils/profiling.profile_layers``
   times the -bf16 forward layer by layer with CUDA events, the forward
   queued behind a device sleep so that they time its kernels and not the
   host's dispatch.
12. parallel: the multi-device axes (``parallel/mesh.py``, ``parallel/pp.py``)
   on the one card, every position a stream of cuda:0 (``devices=[cuda:0] *
   n``), yolov3-416 with random weights (seed 7) at b=2: int8 ``xla`` under
   data2, model2, space2 and data2 x space2 x model2 (8 positions), and
   ``-turbo_int8`` under space2 x model2 (the int8 trunk's tensors cross the
   collectives beside their float views), heads bit-identical to the
   single-device Predictor's, K1 launched once a position and int8 conv
   (71 x positions; each position of a sharded conv holds its M/2 weight
   rows); int8 ``fused`` as 2 pipeline stages at
   microbatch 1, as pp2 x tp2, and as 2 replicas x pp2, bit-identical to the
   fused forward image by image, K2 within a stage's runs and K1 where a
   residual run straddles a boundary or a collective, as the rule counts
   them; tiny-yolo-obj_xnor-416 ``pallas_mxu`` and ``pallas`` under model2
   (K4, K3 once a position and bit-path conv, heads bit-identical);
   ``-bf16`` under data2
   (bit-identical: K6 is batch-invariant) and space2 (heads within phase
   11's bf16 limits, K6 within its float32-accumulate bound at every slab
   shape); fp32 under model2 and space2 (within ``PAR_FLOAT``, the max gap
   printed). ``DetectionPipeline`` with device NMS on 640x480 uint8 frames
   at b=2 under data2 x model2 and pp2: the single-device pipeline's
   detections (``check_near_lines``), K7 and the walk once a batch after
   the gather. The pp2 wavefront run 50 times without synchronising, every
   run bit-identical (cross-stream lifetimes). ``detector test -pp 2`` on
   the one card exits 1 with "need 2 devices, have 1". Walls beside the
   single-device ones, labelled "one card, n positions": they show the cost
   of the extra launches and copies, not scaling. Then the communication
   account (``parallel/commvol.py``): with the recorder on, yolov3-416 int8
   ``xla`` at b=2 under dp2, tp2, sp2, tp4, tp8, sp4, sp8 and dp2 x sp2 x
   tp2, ``-turbo_int8`` under sp2 x tp2, and int8 ``fused`` as pp2 and pp4,
   each entry counted as if every position had its own GPU; the entries
   equal the count from layer shapes (``tests/commvol_count.py``: gathers,
   halo rows, the input's rows, the heads' rows onto the first position,
   ``-turbo_int8``'s int8 trunk tensors beside the float32 ones at 1 byte
   an element; each stage boundary's live tensors, as
   ``pp_boundary_bytes``), and the heads and every launch count equal those
   of the same call with the recorder off; ``-bf16`` under sp2 moves what
   int8 sp2 does. The compute anchors: one position's device ms per image
   at b=8 (CUDA events behind a device sleep) in int8 ``xla`` and
   ``-bf16``; the projected table on NVIDIA's published H100 SXM NVLink
   figure (not measured), printed and on a ``{"commvol": ...}`` line.
13. yolov4: K1's mish form (``csrc/int8_conv_mish.cu``) against its plain
   twin (the linear epilogue's, then ``F.mish``, on the card), bit for bit,
   in the cpu and the gpu epilogue, at the 25 classes of yolov4-416's 71
   mish int8 convs (``portbench/configs/yolov4-416.cfg``, b=1); the cpu
   form timed beside its bound, the leaky form at the same shape, the plain
   twin and ``torch._int_mm``, summed over the 71. Then one yolov4-416 int8
   forward (random weights, seed 7) with the launch counts zeroed just
   before it: 71 launches of ``f32/cpu/f32/mish`` and 35 of
   ``f32/cpu/f32``, nothing in front; heads equal to the plain path's;
   under torch.profiler in a process of its own, 71 kernels of the mish
   form and conv0's ``F.mish`` the only kernels named mish (no separate
   mish pass). A
   ``{"yolov4": ...}`` line after the ``{"commvol": ...}`` line.

Every kernel time is printed beside the least time the card could take for
the same work: the bytes the function must move (each input read once, each
output written once) over the HBM rate, or its operations over the peak of
their type, whichever is longer: the int8 tensor cores' for K1 and K2, the
binary tensor cores' for the XNOR kernels' +-1 multiply-adds (8x the int8
peak, the rate scripts/trace_xnor_gemm.py measures; Hopper's data sheet
gives none). The XNOR lines also print the bound with the +-1
multiply-adds at the int8 peak, the count of the earlier XNOR figures.

Any failure raises and exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
preceded by the card's name and power limit and, before that, a line with one
JSON object describing each of the six TPU kernels' counterparts, K6 and the
device NMS's K7 and walk (after
a ``{"slice11": ...}`` line with phase 11's numbers, a
``{"pipeline": ...}`` line with phase 8's numbers and the NMS kernels' rows, a
``{"precision": ...}`` line with phase 9's, a ``{"cpu_old": ...}`` line
with phase 10's, a ``{"parallel": ...}`` line with phase 12's and a
``{"commvol": ...}`` line with its communication account and a
``{"yolov4": ...}`` line with phase 13's forward): its launches on the main path, its time, the plain
version's, the bound (sums over the shapes timed) and the library call's
where there is one, and a row for each of K1's forms on the precision
modes', the cpu_old path and yolov4's mish convs, with its launches
there. Two Pallas functions
that compute one function share a Hopper kernel and its numbers.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from yolo2_light_tpu_torch import pipeline
from yolo2_light_tpu_torch.apps import cli, detect
from yolo2_light_tpu_torch.cfg import (ConvSpec, RegionSpec, ShortcutSpec,
                                       YoloSpec, parse_network_cfg)
from yolo2_light_tpu_torch.io import image as im_io
from yolo2_light_tpu_torch.models import layers, network
from yolo2_light_tpu_torch.io.rawvideo import write_rawvideo
from yolo2_light_tpu_torch.ops import (_build, bf16_conv, fused_res,
                                       int8_conv, nms_order, nms_walk,
                                       xnor_gemm)
from yolo2_light_tpu_torch.parallel import commvol
from yolo2_light_tpu_torch.parallel import mesh as par_mesh
from yolo2_light_tpu_torch.parallel import pp as par_pp
from yolo2_light_tpu_torch.params import save_random_weights
from yolo2_light_tpu_torch.post import boxes as post_boxes
from yolo2_light_tpu_torch.post import device_nms
from yolo2_light_tpu_torch.utils import profiling
from yolo2_light_tpu_torch.weights import random_params, save_weights
from yolo2_light_tpu_torch.xnor import pack_sign_weights
from tests import commvol_count

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
CFG = os.path.join(DATA, "yolov3.cfg")
SMALL_CFG = os.path.join(DATA, "mini-yolo3.cfg")
IMAGE = os.path.join(DATA, "dog160.png")
SEED = 7
SLEEP_CYCLES = 50_000_000   # about 25 ms of device time to queue behind
# NVIDIA H100 SXM peaks (data sheet, dense): int8 and bf16 tensor cores,
# HBM3
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
# the binary tensor cores (mma .b1 m16n8k256): an m16n8k256 .b1 MMA retires
# at the m16n8k32 .s8 MMA's rate with 8x its multiply-adds
# (scripts/trace_xnor_gemm.py's probe)
PEAK_B1_OPS = 8 * PEAK_INT8_OPS
# K3's floor: __popc issue, 16 an SM a clock, 132 SMs at the 1.98 GHz boost
POPC_PER_SECOND = 16 * 132 * 1.98e9
THRESH = "0.25"         # the CLI's default -thresh
N_CLASSES = 80
HEAD_GRIDS = [13, 26, 52]
# (label, (B, H, W, C, M, ks, stride, pad)): yolov3-416's 15 int8 conv
# classes, (size, stride) at each output size, at yolov3's widths
SHAPES = [
    ("1x1/s1 208x208x64->32", (1, 208, 208, 64, 32, 1, 1, 0)),
    ("1x1/s1 104x104x128->64", (1, 104, 104, 128, 64, 1, 1, 0)),
    ("1x1/s1 52x52x256->128", (1, 52, 52, 256, 128, 1, 1, 0)),
    ("1x1/s1 26x26x512->256", (1, 26, 26, 512, 256, 1, 1, 0)),
    ("1x1/s1 13x13x1024->512", (1, 13, 13, 1024, 512, 1, 1, 0)),
    ("3x3/s1 208x208x32->64", (1, 208, 208, 32, 64, 3, 1, 1)),
    ("3x3/s1 104x104x64->128", (1, 104, 104, 64, 128, 3, 1, 1)),
    ("3x3/s1 52x52x128->256", (1, 52, 52, 128, 256, 3, 1, 1)),
    ("3x3/s1 26x26x256->512", (1, 26, 26, 256, 512, 3, 1, 1)),
    ("3x3/s1 13x13x512->1024", (1, 13, 13, 512, 1024, 3, 1, 1)),
    ("3x3/s2 416x416x32->208x208x64", (1, 416, 416, 32, 64, 3, 2, 1)),
    ("3x3/s2 208x208x64->104x104x128", (1, 208, 208, 64, 128, 3, 2, 1)),
    ("3x3/s2 104x104x128->52x52x256", (1, 104, 104, 128, 256, 3, 2, 1)),
    ("3x3/s2 52x52x256->26x26x512", (1, 52, 52, 256, 512, 3, 2, 1)),
    ("3x3/s2 26x26x512->13x13x1024", (1, 26, 26, 512, 1024, 3, 2, 1)),
]
IN_MULT, W_MULT = 40.0, 16.0
# phase 13: yolov4-416 (the benchmark's cfg), K1's mish form
V4_CFG = os.path.join(ROOT, "portbench", "configs", "yolov4-416.cfg")
V4_FORMS = {"f32/cpu/f32/mish": 71, "f32/cpu/f32": 35}
MISH_SOURCE = "yolo2_light_tpu_torch/csrc/int8_conv_mish.cu"
KERNEL_SOURCE = "yolo2_light_tpu_torch/csrc/int8_conv.cu"
REPLACES = "yolo2_light_tpu/ops/pallas_int8.py:141"        # conv3x3_int8_tiled
ALSO_REPLACES = "yolo2_light_tpu/ops/pallas_int8.py:71"    # conv3x3_int8_fused
# (label, (B, H, W, C, C2)): yolov3-416's residual blocks, one per stage
FUSED_SHAPES = [
    ("208x208 64->32->64", (1, 208, 208, 64, 32)),
    ("104x104 128->64->128", (1, 104, 104, 128, 64)),
    ("52x52 256->128->256", (1, 52, 52, 256, 128)),
    ("26x26 512->256->512", (1, 26, 26, 512, 256)),
    ("13x13 1024->512->1024", (1, 13, 13, 1024, 512)),
]
FUSED_SOURCE = "yolo2_light_tpu_torch/csrc/fused_res.cu"
FUSED_REPLACES = "yolo2_light_tpu/ops/pallas_fused.py:272"  # fused_res_stage
FUSED_ALSO_REPLACES = "yolo2_light_tpu/ops/pallas_fused.py:358"  # ..._strips
N_FUSED_BLOCKS = 23     # 1 + 2 + 8 + 8 + 4 residual blocks
N_UNFUSED_INT8 = 25     # 71 int8 convs minus the blocks' 46
XNOR_CFG = os.path.join(DATA, "tiny-yolo-obj_xnor.cfg")
# (label, (B, H, W, C, M)): tiny-yolo-obj_xnor-416's XNOR convs, 3x3/s1/p1
XNOR_SHAPES = [
    ("208x208 16->32", (1, 208, 208, 16, 32)),
    ("104x104 32->64", (1, 104, 104, 32, 64)),
    ("52x52 64->128", (1, 52, 52, 64, 128)),
    ("26x26 128->256", (1, 26, 26, 128, 256)),
    ("13x13 256->512", (1, 13, 13, 256, 512)),
    ("13x13 512->1024", (1, 13, 13, 512, 1024)),
    ("13x13 1024->1024", (1, 13, 13, 1024, 1024)),
]
XNOR_KERNELS = {   # name: (source, the TPU kernel it replaces)
    "xnor_gemm": ("yolo2_light_tpu_torch/csrc/xnor_gemm.cu",
                  "yolo2_light_tpu/ops/pallas_xnor.py:156"),
    "xnor_gemm_mxu": ("yolo2_light_tpu_torch/csrc/xnor_gemm_mxu.cu",
                      "yolo2_light_tpu/ops/pallas_xnor.py:280"),
}
XNOR_IMPLS = ("int8", "pallas", "pallas_mxu", "auto")
VOC_CLASSES = 20
XNOR_THRESH = "0.1"     # with random weights no box reaches 0.25
# every kernel of csrc/ and the call that binds it
KERNEL_LOADERS = {
    "int8_conv": int8_conv.load_kernel,
    "int8_conv_mish": lambda: int8_conv.load_kernel(mish=True),
    "fused_res": fused_res.load_kernel,
    "xnor_gemm": lambda: xnor_gemm.load_kernel("xnor_gemm"),
    "xnor_gemm_mxu": lambda: xnor_gemm.load_kernel("xnor_gemm_mxu"),
    "nms_walk": nms_walk.load_kernel,
    "nms_order": nms_order.load_kernel,
    "bf16_conv": bf16_conv.load_kernel,
}
# phase 8: the serving pipeline
NMS_SOURCE = "yolo2_light_tpu_torch/csrc/nms_walk.cu"
# the lax.while_loop of nms_probs_with_order (an XLA loop, no pallas_call)
NMS_REPLACES = "yolo2_light_tpu/post/device_nms.py:93"
NMS_SHAPES = [(8, 256, 80), (8, 1024, 80), (8, 4096, 80)]   # B, K, C
NMS_C20_SHAPES = [(8, 1024, 20), (1, 1024, 20)]   # tiny-yolo-obj_xnor's C
ORDER_SOURCE = "yolo2_light_tpu_torch/csrc/nms_order.cu"
# pairwise_iou, iou > thresh, the lax.scan of stable argsorts and
# rank_has_work of nms_probs_with_order (XLA ops, no pallas_call)
ORDER_REPLACES = "yolo2_light_tpu/post/device_nms.py:69"
# the modes whose NMS stage phase 8 times at the pipeline's own shape
NMS_STAGE_MODES = ("yolov3 int8", "tiny-yolo-obj_xnor pallas_mxu")
FRAME_H, FRAME_W = 480, 640
MAP_IMAGES = 16
TARGET_LIVE = 300       # candidates of a frame above detector map's thresh
PIPE_THRESH, PIPE_NMS, PIPE_K = 0.005, 0.45, 1024   # detector map's settings
# name: (cfg, -quantized, pipeline keywords, the hand kernel of its forward)
PIPE_MODES = {
    "yolov3 int8": (CFG, True, {"int8_impl": "xla"}, "int8_conv"),
    "yolov3 int8 fused": (CFG, True, {"int8_impl": "fused"},
                          "fused_res_block"),
    "yolov3 fp32": (CFG, False, {}, None),
    "tiny-yolo-obj_xnor pallas_mxu": (XNOR_CFG, False,
                                      {"xnor_impl": "pallas_mxu"},
                                      "xnor_gemm_mxu"),
    "tiny-yolo-obj_xnor pallas": (XNOR_CFG, False, {"xnor_impl": "pallas"},
                                  "xnor_gemm"),
    # phase 9's precision modes in the pipeline
    "yolov3 int8 gpu": (CFG, True, {"int8_policy": "gpu"}, "int8_conv"),
    "yolov3 int8 turbo": (CFG, True, {"turbo": True}, "int8_conv"),
    "yolov3 int8 turbo_int8": (CFG, True, {"turbo": "int8"}, "int8_conv"),
    "yolov3 int8 bf16": (CFG, True, {"compute_dtype": torch.bfloat16},
                         "int8_conv"),
    "yolov3 bf16": (CFG, False, {"compute_dtype": torch.bfloat16},
                    "bf16_conv"),
}
# phase 9: K1's forms, "<input>/<semantics>/<store>" as
# int8_conv.FORM_LAUNCHES names them, and what runs each on the main path
K1_PATH_FORMS = {
    "bf16/cpu/bf16": "bf16 input and store (-turbo)",
    "f32/gpu/f32": "gpu epilogue (-int8_policy gpu)",
    "f32/cpu/int8": "int8 store (-turbo_int8)",
    "int8/cpu/int8": "chained int8 input, int8 store (-turbo_int8)",
}
# forms no phase 9 run launches, checked all the same: the bf16 input and
# the bf16 store each alone, and the gpu epilogue with the narrow stores
K1_OTHER_FORMS = ("bf16/cpu/f32", "f32/cpu/bf16", "bf16/gpu/bf16",
                  "int8/gpu/int8")
GPU_CLASSES = {label for label, (_, _, _, _, _, ks, s, _) in SHAPES
               if (ks, s) == (3, 1)} | {"3x3/s2 416x416x32->208x208x64"}
STORE_MULT = 12.5        # the int8 store's multiplier in the form checks
# phase 10: -int8_policy cpu_old and detector calibrate on yolov2-voc-416
VOC_CFG = os.path.join(DATA, "yolov2-voc.cfg")
OLD_STORES = {"f32": torch.float32, "int8": torch.int8,
              "f32+int8": int8_conv.OLD_BOTH}
# (label, (B, H, W, C, M, ks, stride, pad), the store cpu_old takes there):
# yolov2-voc-416's 12 int8 conv classes
VOC_OLD_CLASSES = [
    ("3x3/s1 208x208x32->64", (1, 208, 208, 32, 64, 3, 1, 1), "int8"),
    ("3x3/s1 104x104x64->128", (1, 104, 104, 64, 128, 3, 1, 1), "int8"),
    ("1x1/s1 104x104x128->64", (1, 104, 104, 128, 64, 1, 1, 0), "int8"),
    ("3x3/s1 52x52x128->256", (1, 52, 52, 128, 256, 3, 1, 1), "int8"),
    ("1x1/s1 52x52x256->128", (1, 52, 52, 256, 128, 1, 1, 0), "int8"),
    ("3x3/s1 26x26x256->512", (1, 26, 26, 256, 512, 3, 1, 1), "int8"),
    ("1x1/s1 26x26x512->256", (1, 26, 26, 512, 256, 1, 1, 0), "int8"),
    ("3x3/s1 13x13x512->1024", (1, 13, 13, 512, 1024, 3, 1, 1), "int8"),
    ("1x1/s1 13x13x1024->512", (1, 13, 13, 1024, 512, 1, 1, 0), "int8"),
    ("3x3/s1 13x13x1024->1024", (1, 13, 13, 1024, 1024, 3, 1, 1), "int8"),
    ("1x1/s1 26x26x512->64", (1, 26, 26, 512, 64, 1, 1, 0), "int8"),
    ("3x3/s1 13x13x1280->1024", (1, 13, 13, 1280, 1024, 3, 1, 1), "f32"),
]
OLD_PATH_FORMS = {
    "int8/old/int8": "cpu_old: int8 out to a conv, maxpool, route or reorg",
    "int8/old/f32": "cpu_old: q/16 out to the linear head conv",
}
# K1's launches by form in one cpu_old forward of yolov2-voc-416: convs
# 2-26 store int8, conv 29 (read by the linear head conv 30) float32
OLD_EXPECT_FORMS = {"int8/old/int8": 20, "int8/old/f32": 1}
OLD_THRESH = "0.01"      # random weights put few boxes above 0.25
CALIB_IMAGES = 8
# phase 11: K6 (-bf16's float convs), detector demo, the softmax tree
BF16_SOURCE = "yolo2_light_tpu_torch/csrc/bf16_conv.cu"
# XLA's bf16 conv of the JAX package (lax.conv_general_dilated with
# preferred_element_type=float32 in conv2d_fp32; no pallas_call)
BF16_REPLACES = "yolo2_light_tpu/models/layers.py:103"
DEMO_FRAMES = 24         # the video whose lines are held to the pipeline's
DEMO_FPS_FRAMES = 256    # the longer video the frames per second come from
DEMO_WARM = 8            # frames before the demo's FPS figure is steady
DEMO_THRESH = 0.25       # the CLI's default -thresh
DEMO_LIVE = 30           # candidates of a frame above it
# tests/test_tree.py's mini YOLO9000 net: a 7-class tree of 3 groups
TREE_TEXT = """animal -1
vehicle -1
cat 0
dog 0
car 1
truck 1
bus 1
"""
TREE_NAMES = ["animal", "vehicle", "cat", "dog", "car", "truck", "bus"]
TREE_CFG = """[net]
batch=1
subdivisions=1
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
size=1
stride=1
pad=1
filters=60
activation=linear

[region]
anchors = 1.08,1.19,  3.42,4.41,  6.63,11.38,  9.42,5.11,  16.62,10.52
classes=7
coords=4
num=5
softmax=1
tree={tree_path}
"""
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
# name: (cfg, CLI flags, Predictor keywords, the launches of one forward,
# whether no quantize or input copy may precede an int8 conv)
PRECISION_RUNS = {
    "yolov3 -quantized -int8_policy gpu": (
        CFG, ["-quantized", "-int8_policy", "gpu"], {"int8_policy": "gpu"},
        {"int8_conv": 26}, True),
    "yolov3 -quantized -turbo": (CFG, ["-quantized", "-turbo"],
                                 {"turbo": True}, {"int8_conv": 71}, True),
    "yolov3 -quantized -turbo_int8": (
        CFG, ["-quantized", "-turbo_int8"], {"turbo": "int8"},
        {"int8_conv": 71}, False),
    "yolov3 -quantized -turbo_int8 -int8_impl fused": (
        CFG, ["-quantized", "-turbo_int8", "-int8_impl", "fused"],
        {"turbo": "int8", "int8_impl": "fused"},
        {"int8_conv": N_UNFUSED_INT8, "fused_res_block": N_FUSED_BLOCKS},
        False),
    "yolov3 -quantized -bf16": (CFG, ["-quantized", "-bf16"],
                                {"compute_dtype": torch.bfloat16},
                                {"int8_conv": 71, "bf16_conv": 4}, True),
    "yolov3 -bf16": (CFG, ["-bf16"], {"compute_dtype": torch.bfloat16},
                     {"bf16_conv": 75}, True),
    "tiny-yolo-obj_xnor -turbo -xnor_kernel pallas_mxu": (
        XNOR_CFG, ["-turbo", "-xnor_kernel", "pallas_mxu"],
        {"turbo": True, "xnor_impl": "pallas_mxu"}, {"xnor_gemm_mxu": 7},
        True),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def event_ms(fn, iters: int = 50, warmup: int = 5,
             sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. The
    calls are queued behind a device-side sleep, so the host's dispatch
    (tens of microseconds a call) overlaps it and is not timed."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def forward_ms(pred, x, iters: int = 20, warmup: int = 3) -> float:
    """Median host wall time of one synchronised forward (input on the
    host, as ``detector test`` feeds it)."""
    for _ in range(warmup):
        pred(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pred(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_cli(args):
    """``cli.main(args)`` with its streams captured; returns (rc, stdout,
    stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    if rc != 0:
        sys.stderr.write(err.getvalue()[-4000:])
    return rc, out.getvalue(), err.getvalue()


def detection_text(stdout: str) -> str:
    """The detection lines ``detector test`` prints after 'Predicted in'."""
    check("Predicted in" in stdout, "no 'Predicted in' line in the output")
    tail = stdout.split("Predicted in", 1)[1]
    return tail.split("\n", 1)[1].rstrip("\n") if "\n" in tail else ""


def check_same_lines(a: str, b: str, what: str) -> None:
    la, lb = a.splitlines(), b.splitlines()
    if la == lb:
        return
    diff = [(i, x, y) for i, (x, y) in enumerate(zip(la, lb)) if x != y]
    print(f"{what}: {len(la)} vs {len(lb)} lines, {len(diff)} differ; "
          f"first: {diff[:5]}", file=sys.stderr)
    raise AssertionError(f"{what} differ")


def check_heads(heads, what: str) -> None:
    check([h.index for h in heads] == [82, 94, 106], f"{what}: head layers")
    for h, g in zip(heads, HEAD_GRIDS):
        check(tuple(h.data.shape) == (1, g, g, 3, 5 + N_CLASSES),
              f"{what}: head {h.index} shape {tuple(h.data.shape)}")
        check(bool(torch.isfinite(h.data).all()),
              f"{what}: head {h.index} has non-finite values")


# -bf16 at full width (yolov3-416, random weights, seed 7): the kernel
# path's heads and lines against the plain path's, whose float convs run
# K6's plain twin. Both sum the same exact bfloat16 products in another
# order; a sum within an ULP of a bfloat16 boundary of the next conv's input
# rounds the other way, and that step (2**-8 of the value) travels
# downstream and grows over yolov3's 75 convs, so no elementwise bound holds
# for every entry (phase 11 holds each conv to its float32-accumulate
# bound). Both convs are deterministic, so every run on a card reads the
# same. Limits, set from the readings of a sound run (PERF.md, section 6):
BF16_HEADS_WITHIN = 0.999   # least share of a head within HEADS_TOL
BF16_HEADS_MAX = 1.0        # largest difference of any entry
BF16_LINES_UNLIKE = 0.15    # most share of lines not among the plain path's


def check_bf16_heads(pairs, what: str) -> dict:
    """The kernel path's head maps against the plain path's under -bf16:
    every head's mean difference below ``bf16_conv.HEADS_MEAN`` (the CPU
    tests' bf16 bound), at least BF16_HEADS_WITHIN of its entries within
    rtol and atol ``bf16_conv.HEADS_TOL``, and no entry further than
    BF16_HEADS_MAX. Returns the readings over all heads: the least share
    within, the largest mean and the largest difference."""
    gaps = []
    for got, want, index in pairs:
        g = bf16_conv.heads_gap(got, want)
        check(g.within >= BF16_HEADS_WITHIN
              and g.mean < bf16_conv.HEADS_MEAN and g.max <= BF16_HEADS_MAX,
              f"{what} head {index}: beyond the bf16 limits "
              f"({100 * g.within:.4f}% of the entries within rtol/atol "
              f"{bf16_conv.HEADS_TOL}, mean {g.mean:.3g}, max {g.max:.3g})")
        gaps.append(g)
    return {"within_min": min(g.within for g in gaps),
            "mean_max": max(g.mean for g in gaps),
            "max": max(g.max for g in gaps)}


def check_bf16_lines(lines: list, plain_lines: list, what: str) -> int:
    """The kernel path's detection lines under -bf16 against the plain
    path's: at most BF16_LINES_UNLIKE of them not among the plain path's.
    Returns that count."""
    unlike = len(lines) - sum((collections.Counter(lines)
                               & collections.Counter(plain_lines)).values())
    check(bool(lines) and unlike <= BF16_LINES_UNLIKE * len(lines),
          f"{what}: {unlike} of {len(lines)} detection lines not among the "
          f"plain path's {len(plain_lines)}, more than "
          f"{100 * BF16_LINES_UNLIKE:.0f}%")
    return unlike


def k6_bare(x, w, stride: int, pad: int):
    """K6's bare conv of ``x`` and ``[M,ks,ks,C]`` weights ``w``, the c3
    form's padded rows made here."""
    k32 = (bf16_conv.pad_k32(w) if bf16_conv.c3_form(w.shape[3], w.shape[1])
           else None)
    return bf16_conv.conv2d_bf16_cuda(x, w, stride, pad, w_k32=k32)


@contextlib.contextmanager
def k6_on_the_plain_path():
    """Inside the block the plain path's -bf16 float convs run K6 itself
    (its twin swapped out), so that the other kernels of a mode are held bit
    for bit against their plain twins with K6 on both sides."""
    twin = bf16_conv.conv2d_bf16_plain
    bf16_conv.conv2d_bf16_plain = k6_bare
    try:
        yield
    finally:
        bf16_conv.conv2d_bf16_plain = twin


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return line


def _timed_build(name: str):
    t0 = time.perf_counter()
    path = _build.build(name)
    return path, time.perf_counter() - t0


def phase_build() -> None:
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_LOADERS)) as pool:
        builds = list(pool.map(_timed_build, KERNEL_LOADERS))
    for load in KERNEL_LOADERS.values():
        load()
    for name, (path, sec) in zip(KERNEL_LOADERS, builds):
        say("build", f"csrc/{name}.cu -> {os.path.relpath(path, ROOT)} "
            f"({sec:.2f} s)")
    say("build", f"{len(builds)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(the builds alone: {sum(s for _, s in builds):.2f} s), built in "
        f"parallel (nvcc {' '.join(_build.NVCC_FLAGS)})")


def bound(bytes_moved: float, ops: float,
          peak_ops: float = PEAK_INT8_OPS) -> tuple:
    """The least time the card could take for work that moves
    ``bytes_moved`` (each input read once, each output written once) and
    does ``ops`` operations at ``peak_ops`` a second (by default int8):
    (ms, "bytes" or "operations")."""
    b_ms = bytes_moved / PEAK_BYTES * 1e3
    o_ms = ops / peak_ops * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def xnor_bound(xp, wp, c: int, peak_ops: float = PEAK_B1_OPS) -> tuple:
    """:func:`bound` of one 3x3, stride 1, pad 1 XNOR conv of packed
    ``xp`` [B, H, W, C32] and ``wp`` [M, 3, 3, C32] over C real channels:
    the packed input, the weights, mean and bias read, the f32 output
    written; the +-1 multiply-adds at ``peak_ops`` (by default the binary
    tensor cores')."""
    b, h, w, _ = xp.shape
    m = wp.shape[0]
    return bound(4 * (xp.numel() + wp.numel() + 2 * m + b * h * w * m),
                 2.0 * b * h * w * m * 9 * c, peak_ops)


def row_bound(rows: list) -> dict:
    """A kernel's bound over the shapes timed: the sum, and the term that
    bounds most of it."""
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
    return {"bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(by, key=by.get)}


def conv_bound(l) -> tuple:
    """K1's bound for the int8 conv ``l`` of a spec (f32 input read once,
    int8 weights and f32 bias, f32 output written once)."""
    p = l.out_h * l.out_w
    k = l.size * l.size * l.c
    return bound(4 * l.h * l.w * l.c + l.n * k + 4 * l.n + 4 * p * l.n,
                 2.0 * p * l.n * k)


def block_bound(l1, l2) -> tuple:
    """K2's bound for the residual block of convs ``l1`` (1x1, C -> C2) and
    ``l2`` (3x3, C2 -> C): the f32 trunk read once and written once."""
    p, c, c2 = l1.h * l1.w, l1.c, l1.n
    return bound(2 * 4 * p * c + c2 * c + 9 * c * c2 + 4 * (c2 + c),
                 2.0 * p * (c * c2 + 9 * c2 * c))


def im2col_int8(x8, ks: int, stride: int, pad: int):
    """The ``[P, ks*ks*C]`` int8 patch matrix of NHWC ``x8``, taps in the
    kernel's weight order (ky, kx, c)."""
    b, _, _, c = x8.shape
    cols = torch.nn.functional.unfold(x8.permute(0, 3, 1, 2).float(), ks,
                                      padding=pad, stride=stride)
    cols = cols.view(b, c, ks * ks, -1).permute(0, 3, 2, 1)
    return cols.reshape(-1, ks * ks * c).to(torch.int8).contiguous()


def phase_kernels() -> list:
    dev = torch.device("cuda")
    alpha = int8_conv.alpha_f32(IN_MULT, W_MULT)
    rows = []
    for i, (label, (b, h, w, c, m, ks, s, pad)) in enumerate(SHAPES):
        rng = np.random.RandomState(SEED + i)
        x = torch.from_numpy((rng.randn(b, h, w, c) * 4).astype(
            np.float32)).to(dev)
        x8 = int8_conv.quantize_i8(x, IN_MULT)
        wt = torch.from_numpy(rng.randint(-127, 128, (m, ks, ks, c)).astype(
            np.int8)).to(dev)
        bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
        plan = int8_conv.plan_launch(b, h, w, c, m, ks, s, pad)
        err = 0.0
        for act in ("leaky", "linear"):
            out = int8_conv.conv2d_int8_f32_cuda(x, wt, bias, IN_MULT, alpha,
                                                 s, pad, act)
            out8 = int8_conv.conv2d_int8_cuda(x8, wt, bias, alpha, s, pad, act)
            ref = int8_conv.conv2d_int8_plain(x8, wt, bias, alpha, s, pad, act)
            torch.cuda.synchronize()
            check(torch.equal(out, ref),
                  f"kernel (f32 input) != plain at {label} ({act})")
            check(torch.equal(out8, ref),
                  f"kernel (int8 input) != plain at {label} ({act})")
            err = max(err, float((out - ref).abs().max()),
                      float((out8 - ref).abs().max()))
        # the yardstick: cuBLASLt's int8 GEMM on the same product, patches
        # gathered beforehand, no epilogue; never on the port's path
        a = im2col_int8(x8, ks, s, pad)
        wmat = wt.view(m, -1).t()
        acc = int8_conv.int8_conv_acc_plain(x8, wt, s, pad)
        check(torch.equal(torch._int_mm(a, wmat), acc.view(-1, m)),
              f"torch._int_mm != the plain accumulator at {label}")
        row = {"shape": label, "tile": [plan.tile_h, plan.tile_w],
               "split": plan.split, "blocks": plan.blocks,
               "max_abs_err": err}
        row["ms"] = event_ms(lambda: int8_conv.conv2d_int8_f32_cuda(
            x, wt, bias, IN_MULT, alpha, s, pad, "leaky"))
        row["ms_int8_input"] = event_ms(lambda: int8_conv.conv2d_int8_cuda(
            x8, wt, bias, alpha, s, pad, "leaky"))
        row["plain_ms"] = event_ms(lambda: int8_conv.conv2d_int8_f32_plain(
            x, wt, bias, IN_MULT, alpha, s, pad, "leaky"), iters=10)
        row["library_ms"] = event_ms(lambda: torch._int_mm(a, wmat))
        p = acc.numel() // m
        weights = wt.numel() + 4 * m
        ops = 2.0 * p * m * ks * ks * c
        row["bound_ms"], row["bound_by"] = bound(
            4 * x.numel() + weights + 4 * p * m, ops)
        row["bound_ms_int8_input"], _ = bound(x8.numel() + weights
                                              + 4 * p * m, ops)
        say("kernels", f"{label}: f32 and int8 input bit-identical to plain "
            f"(max_abs_err {err}); tile {plan.tile_h}x{plan.tile_w}, split "
            f"{plan.split}, {plan.blocks} blocks; kernel {row['ms']:.4f} ms "
            f"(int8 input {row['ms_int8_input']:.4f}), plain "
            f"{row['plain_ms']:.4f}, torch._int_mm {row['library_ms']:.4f} "
            f"ms; bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
        rows.append(row)
    return rows


def phase_int8(tmp: str, weights: str, names_file: str, names: list):
    args = ["detector", "test", names_file, CFG, weights, IMAGE, "-quantized",
            "-dont_show", "-thresh", THRESH, "-save",
            os.path.join(tmp, "pred_int8")]
    int8_conv.reset_launch_counts()
    rc, out, _ = run_cli(args)
    launches = int8_conv.LAUNCH_COUNTS["int8_conv"]
    pre = dict(int8_conv.PRE_LAUNCHES)
    check(rc == 0, f"detector test -quantized exited {rc}")
    kernel_text = detection_text(out)
    predicted = [l for l in out.splitlines() if "Predicted in" in l][0]
    say("int8", f"CLI: {predicted}; {len(kernel_text.splitlines())} "
        "detection lines")

    spec, params, _ = detect.build_params(CFG, weights, quantized=True,
                                          echo=False)
    int8_set = network._int8_layer_set(spec, "cpu")
    check(len(int8_set) == 71, f"int8 set of yolov3 has {len(int8_set)} convs")
    check(launches == len(int8_set),
          f"int8 kernel launched {launches} times in one forward, expected "
          f"{len(int8_set)}")
    check(not any(pre.values()),
          f"launches in front of the int8 convs in one forward: {pre}")
    say("int8", f"int8_conv launches in one forward: {launches} (int8 set: "
        f"{len(int8_set)} of {len(spec.conv_layers())} convs); no separate "
        "quantize launch, no input copy")
    k1_bound = sum(conv_bound(spec.layers[i])[0] for i in int8_set)
    say("int8", f"K1's bound over the forward's {len(int8_set)} int8 convs: "
        f"{k1_bound * 1e3:.2f} us")

    kernel = network.Predictor(spec, params, "int8", device="cuda")
    plain = network.Predictor(spec, params, "int8", device="cuda",
                              int8_impl="plain")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    hk, hp, hk2 = kernel(x), plain(x), kernel(x)
    check_heads(hk, "int8 kernel path")
    for a, b, c in zip(hk, hp, hk2):
        check(torch.equal(a.data, b.data),
              f"int8 head {a.index}: kernel path != plain path")
        check(torch.equal(a.data, c.data),
              f"int8 head {a.index}: two kernel-path runs differ")
    say("int8", "head maps of the kernel path and the plain path are equal "
        "(3 heads), and equal across two kernel-path runs")

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        plain_text = detect.run(names, CFG, weights, IMAGE,
                                thresh=float(THRESH), quantized=True,
                                save_path=os.path.join(tmp, "pred_plain"),
                                int8_impl="plain", device="cuda")
    check_same_lines(kernel_text, plain_text.rstrip("\n"),
                     "detection lines of the kernel and the plain path")
    say("int8", "detection lines of the kernel path and the plain path are "
        "identical")

    k_ms = forward_ms(kernel, x)
    p_ms = forward_ms(plain, x, iters=5)
    say("int8", f"warm b=1 forward: kernel path {k_ms:.3f} ms, plain path "
        f"{p_ms:.3f} ms (median, host clock, synchronised)")
    return launches, dict(spec=spec, params=params, x=x, kernel=kernel,
                          k1_heads=hk, plain_heads=hp, k1_text=kernel_text,
                          int8_set=int8_set, k1_bound=k1_bound)


def _block_operands(dev, seed: int, b: int, h: int, w: int, c: int,
                    c2: int, b1_shift: float = 2.0):
    """A trunk and one residual block's arguments, with b1 > 0 so a wrong
    halo mask would show on the image border."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32) * 4)
    m1, m2 = np.float32(rng.uniform(8, 24)), np.float32(rng.uniform(8, 24))
    args = dict(
        w1=torch.from_numpy(rng.randint(-127, 128, (c2, 1, 1, c)).astype(
            np.int8)).to(dev),
        b1=torch.from_numpy((rng.randn(c2) + b1_shift).astype(
            np.float32)).to(dev),
        m1=float(m1), alpha1=int8_conv.alpha_f32(m1, rng.uniform(64, 256)),
        w2=torch.from_numpy(rng.randint(-127, 128, (c, 3, 3, c2)).astype(
            np.int8)).to(dev),
        b2=torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev),
        m2=float(m2), alpha2=int8_conv.alpha_f32(m2, rng.uniform(64, 256)))
    return x.to(dev), args


def _unfused_block(x, a):
    """The int8 conv path's residual block: two int8 conv launches (each
    quantizing its input in its loader), then the shortcut add."""
    t1 = layers.conv2d_int8(x, a["w1"], a["b1"], 1, 0, "leaky", a["m1"],
                            a["alpha1"])
    t2 = layers.conv2d_int8(t1, a["w2"], a["b2"], 1, 1, "leaky", a["m2"],
                            a["alpha2"])
    return layers.shortcut(t2, x, "linear")


def phase_fused_kernels() -> list:
    dev = torch.device("cuda")
    rows = []
    for i, (label, (b, h, w, c, c2)) in enumerate(FUSED_SHAPES):
        x, a = _block_operands(dev, SEED + i, b, h, w, c, c2)
        out = fused_res.fused_res_block_cuda(x, **a)
        ref = fused_res.res_block_plain(x, **a)
        unfused = _unfused_block(x, a)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"fused kernel != plain at {label}")
        check(torch.equal(out, unfused),
              f"fused kernel != int8 conv path at {label}")
        err = float((out - ref).abs().max())
        p = b * h * w
        b_ms, b_by = bound(
            2 * 4 * x.numel() + a["w1"].numel() + a["w2"].numel()
            + 4 * (c2 + c), 2.0 * p * (c * c2 + 9 * c2 * c))
        k_ms = event_ms(lambda: fused_res.fused_res_block_cuda(x, **a))
        u_ms = event_ms(lambda: _unfused_block(x, a))
        p_ms = event_ms(lambda: fused_res.res_block_plain(x, **a), iters=10)
        say("fused", f"{label}: bit-identical to plain and to the int8 conv "
            f"path (max_abs_err {err}); kernel {k_ms:.4f} ms, int8 conv path "
            f"{u_ms:.4f} ms (2 int8_conv + 1 add launches), plain "
            f"{p_ms:.4f} ms; bound {b_ms * 1e3:.2f} us ({b_by}), "
            f"{100 * b_ms / k_ms:.1f}% of it")
        occ = fused_res.occupancy(c, c2, torch.cuda.current_device())
        n_blocks = occ["cluster"] * -(-h // 8) * -(-w // 8) * b
        say("fused", f"{label}: clusters of {occ['cluster']}, {n_blocks} "
            f"blocks, {occ['smem_bytes']} B of dynamic shared memory a block, "
            f"{occ['max_active_clusters']} clusters on the card at once "
            f"({occ['max_active_clusters'] * occ['cluster']} blocks), rings "
            f"{occ['stages1']}/{occ['stages2']} deep, "
            f"{occ['halo_rows_per_pass']} halo rows a phase-1 pass")
        rows.append({"shape": label, "ms": k_ms, "unfused_ms": u_ms,
                     "plain_ms": p_ms, "max_abs_err": err,
                     "bound_ms": b_ms, "bound_by": b_by, "blocks": n_blocks,
                     **occ})
    x, a1 = _block_operands(dev, SEED + 10, 1, 104, 104, 128, 64)
    _, a2 = _block_operands(dev, SEED + 11, 1, 104, 104, 128, 64, -1.0)
    keep = x.clone()
    out = fused_res.run_blocks(x, [a1, a2])
    ref = fused_res.res_block_plain(fused_res.res_block_plain(x, **a1), **a2)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "fused K=2 chain at 104x104 != plain")
    check(torch.equal(x, keep), "fused K=2 chain wrote its input")
    say("fused", "K=2 chain at 104x104x128: bit-identical to plain, input "
        "untouched")
    return rows


def phase_fused(tmp: str, weights: str, names_file: str, k1: dict):
    args = ["detector", "test", names_file, CFG, weights, IMAGE, "-quantized",
            "-int8_impl", "fused", "-dont_show", "-thresh", THRESH, "-save",
            os.path.join(tmp, "pred_fused")]
    int8_conv.reset_launch_counts()
    rc, out, _ = run_cli(args)
    launches = dict(int8_conv.LAUNCH_COUNTS)
    check(rc == 0, f"detector test -quantized -int8_impl fused exited {rc}")
    predicted = [l for l in out.splitlines() if "Predicted in" in l][0]
    say("fused", f"CLI: {predicted}")
    check(launches.get("fused_res_block", 0) == N_FUSED_BLOCKS,
          f"fused kernel launched {launches.get('fused_res_block', 0)} "
          f"times in one forward, expected {N_FUSED_BLOCKS}")
    check(launches.get("int8_conv", 0) == N_UNFUSED_INT8,
          f"int8 conv kernel launched {launches.get('int8_conv', 0)} times "
          f"in one fused forward, expected {N_UNFUSED_INT8}")
    say("fused", f"launches in one forward: fused_res_block "
        f"{launches['fused_res_block']}, int8_conv {launches['int8_conv']}")
    spec = k1["spec"]
    blocks = [(i1, i2) for run in network._fused_stage_runs(
        spec, k1["int8_set"]).values() for i1, i2, _ in run]
    rest = k1["int8_set"] - {i for b in blocks for i in b}
    bounds = {"fused_res_block": sum(block_bound(
                  spec.layers[i1], spec.layers[i2])[0] for i1, i2 in blocks),
              "int8_conv": sum(conv_bound(spec.layers[i])[0] for i in rest)}
    say("fused", f"bounds over the forward: {len(blocks)} blocks "
        f"{bounds['fused_res_block'] * 1e3:.2f} us, {len(rest)} int8 convs "
        f"{bounds['int8_conv'] * 1e3:.2f} us")
    check_same_lines(detection_text(out), k1["k1_text"],
                     "detection lines of the fused and the int8 conv path")
    say("fused", "detection lines of the fused path and the int8 conv path "
        "are identical")

    fused = network.Predictor(k1["spec"], k1["params"], "int8",
                              device="cuda", int8_impl="fused")
    x = k1["x"]
    hf = fused(x)
    check_heads(hf, "fused path")
    for a, b, c in zip(hf, k1["k1_heads"], k1["plain_heads"]):
        check(torch.equal(a.data, b.data),
              f"int8 head {a.index}: fused path != int8 conv path")
        check(torch.equal(a.data, c.data),
              f"int8 head {a.index}: fused path != plain path")
    say("fused", "head maps of the fused path equal those of the int8 conv "
        "path and of the plain path (3 heads)")
    f_ms = forward_ms(fused, x)
    k_ms = forward_ms(k1["kernel"], x)
    say("fused", f"warm b=1 forward: fused path {f_ms:.3f} ms, int8 conv "
        f"path {k_ms:.3f} ms (median, host clock, synchronised)")
    return launches, bounds


def phase_fp32(tmp: str, weights: str, names_file: str) -> None:
    args = ["detector", "test", names_file, CFG, weights, IMAGE, "-dont_show",
            "-thresh", THRESH, "-save", os.path.join(tmp, "pred_fp32")]
    rc, out, _ = run_cli(args)
    check(rc == 0, f"detector test exited {rc}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    predicted = [l for l in out.splitlines() if "Predicted in" in l][0]
    say("fp32", f"CLI: {predicted}; {len(detection_text(out).splitlines())} "
        "detection lines")

    spec, params, _ = detect.build_params(CFG, weights, echo=False)
    pred = network.Predictor(spec, params, "fp32", device="cuda")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    check_heads(pred(x), "fp32")
    say("fp32", f"warm b=1 forward: {forward_ms(pred, x):.3f} ms (median, "
        "host clock, synchronised)")

    # the card against the port's CPU path on a small net
    small, small_params, _ = detect.build_params(SMALL_CFG, None, echo=False)
    xs = np.random.RandomState(SEED).rand(2, 64, 64, 3).astype(np.float32)
    on_card = network.Predictor(small, small_params, device="cuda")(xs)
    on_cpu = network.Predictor(small, small_params, device="cpu")(xs)
    err = 0.0
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a.data.cpu(), b.data, rtol=1e-4, atol=1e-5)
        err = max(err, float((a.data.cpu() - b.data).abs().max()))
    say("fp32", f"mini-yolo3 on the card vs on the CPU: max abs diff {err:.3g} "
        "(rtol 1e-4, atol 1e-5)")


def _xnor_operands(dev, seed: int, b: int, h: int, w: int, c: int,
                   m: int):
    """An input map and one XNOR conv's weights in every engine's layout:
    (x, packed bits, +-1 [O,I,3,3] weights, mean, bias)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
    wt = rng.randn(3, 3, c, m).astype(np.float32)
    sign = np.where(wt > 0, 1, -1).astype(np.int8)
    mean = np.abs(wt).mean((0, 1, 2)).astype(np.float32)
    return (x, torch.from_numpy(pack_sign_weights(sign)).to(dev),
            torch.from_numpy(sign).permute(3, 2, 0, 1).to(
                torch.float32).contiguous().to(dev),
            torch.from_numpy(mean).to(dev),
            torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev))


def _plan_text(plan) -> str:
    return (f"tile {plan.tile_p}x{plan.tile_m}"
            f"{' (warp split)' if plan.warp_split else ''}, K step "
            f"{plan.kstep} words, {plan.stages} stages, cluster split "
            f"{plan.split}, {plan.blocks} blocks")


def phase_xnor_kernels() -> list:
    dev = torch.device("cuda")
    rows = []
    for i, (label, (b, h, w, c, m)) in enumerate(XNOR_SHAPES):
        x, wp, ws, mean, bias = _xnor_operands(dev, SEED + i, b, h, w, c, m)
        xp = xnor_gemm.pack_activations(x, c)
        c32 = xp.shape[-1]
        plans = {eng: xnor_gemm.plan_launch(b, h, w, c32, m, 3, 1, 1, eng)
                 for eng in ("popcount", "mxu")}
        say("xnor", f"{label}: K3 plan {_plan_text(plans['popcount'])}; K4 "
            f"plan {_plan_text(plans['mxu'])}")
        for act in ("leaky", "linear"):
            k3 = xnor_gemm.xnor_gemm_cuda(xp, wp, mean, bias, c, 1, 1, act)
            k4 = xnor_gemm.xnor_gemm_mxu_cuda(xp, wp, mean, bias, c, 1, 1,
                                              act)
            p3 = xnor_gemm.xnor_gemm_plain(xp, wp, mean, bias, c, 1, 1, act)
            p4 = xnor_gemm.xnor_gemm_mxu_plain(xp, wp, mean, bias, c, 1, 1,
                                               act)
            dense = layers.conv2d_xnor(x, ws, mean, bias, 1, 1, act)
            torch.cuda.synchronize()
            check(torch.equal(k3, p3), f"xnor_gemm != plain at {label} ({act})")
            check(torch.equal(k4, p4),
                  f"xnor_gemm_mxu != plain at {label} ({act})")
            check(torch.equal(dense, k3) and torch.equal(dense, k4),
                  f"dense +-1 engine != bit kernels at {label} ({act})")
        row = {"shape": label, "max_abs_err": float(max(
            (k3 - p3).abs().max(), (k4 - p4).abs().max())),
            "plans": {eng: plan._asdict() for eng, plan in plans.items()}}
        # the yardstick: cuBLASLt's int8 GEMM on the +-1 product, patches
        # gathered and unpacked beforehand, no epilogue; never on the
        # port's path
        a8 = xnor_gemm._unpack_pm1(xnor_gemm.im2col_bits(xp, 3, 1, 1)).to(
            torch.int8)
        w8 = xnor_gemm._unpack_pm1(wp.view(m, -1)).to(torch.int8)
        wmat = w8.t()
        _, pad_bits = xnor_gemm._constants(3, c32, c)
        check(torch.equal(xnor_gemm.epilogue_plain(
                  torch._int_mm(a8, wmat) - pad_bits, mean, bias,
                  "linear").view(b, h, w, m), k4),
              f"torch._int_mm's +-1 product != K4 at {label}")
        row["library_ms"] = event_ms(lambda: torch._int_mm(a8, wmat))
        row["bound_ms"], row["bound_by"] = xnor_bound(xp, wp, c)
        int8_peak_ms, _ = xnor_bound(xp, wp, c, PEAK_INT8_OPS)
        popc_floor_ms = b * h * w * m * 9 * c32 / POPC_PER_SECOND * 1e3
        row["xnor_gemm_ms"] = event_ms(lambda: xnor_gemm.xnor_gemm_cuda(
            xp, wp, mean, bias, c, 1, 1, "leaky"))
        row["xnor_gemm_mxu_ms"] = event_ms(
            lambda: xnor_gemm.xnor_gemm_mxu_cuda(xp, wp, mean, bias, c, 1, 1,
                                                 "leaky"))
        for eng in ("popcount", "mxu"):   # input packing + kernel
            row[f"conv_{eng}_ms"] = event_ms(
                lambda: xnor_gemm.conv2d_xnor_bits(
                    x, wp, mean, bias, c_real=c, stride=1, pad=1,
                    engine=eng))
        row["dense_ms"] = event_ms(lambda: layers.conv2d_xnor(
            x, ws, mean, bias, 1, 1, "leaky"))
        row["xnor_gemm_plain_ms"] = event_ms(
            lambda: xnor_gemm.xnor_gemm_plain(xp, wp, mean, bias, c, 1, 1),
            iters=5, warmup=1)
        row["xnor_gemm_mxu_plain_ms"] = event_ms(
            lambda: xnor_gemm.xnor_gemm_mxu_plain(xp, wp, mean, bias, c, 1,
                                                  1), iters=5, warmup=1)
        say("xnor", f"{label}: K3 == plain, K4 == plain, dense == K3 == K4 "
            f"(leaky, linear); K3 {row['xnor_gemm_ms']:.4f} ms, K4 "
            f"{row['xnor_gemm_mxu_ms']:.4f} ms; with input packing K3 "
            f"{row['conv_popcount_ms']:.4f}, K4 {row['conv_mxu_ms']:.4f}, "
            f"dense +-1 engine {row['dense_ms']:.4f} ms; plain K3 "
            f"{row['xnor_gemm_plain_ms']:.4f}, plain K4 "
            f"{row['xnor_gemm_mxu_plain_ms']:.4f} ms; torch._int_mm "
            f"{row['library_ms']:.4f} ms; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}): K3 "
            f"{100 * row['bound_ms'] / row['xnor_gemm_ms']:.1f}%, K4 "
            f"{100 * row['bound_ms'] / row['xnor_gemm_mxu_ms']:.1f}% of it "
            f"(with the +-1 multiply-adds at the int8 peak: "
            f"{int8_peak_ms * 1e3:.2f} us, K3 "
            f"{100 * int8_peak_ms / row['xnor_gemm_ms']:.1f}%, K4 "
            f"{100 * int8_peak_ms / row['xnor_gemm_mxu_ms']:.1f}%); K3 at "
            f"{100 * popc_floor_ms / row['xnor_gemm_ms']:.1f}% of its "
            f"popcount floor ({popc_floor_ms * 1e3:.2f} us)")
        rows.append(row)
    return rows


def check_region_heads(heads, what: str) -> None:
    check([h.index for h in heads] == [15], f"{what}: head layers")
    check(tuple(heads[0].data.shape) == (1, 13, 13, 5, 5 + VOC_CLASSES),
          f"{what}: head shape {tuple(heads[0].data.shape)}")
    check(bool(torch.isfinite(heads[0].data).all()),
          f"{what}: head has non-finite values")


def phase_xnor(tmp: str) -> dict:
    weights = os.path.join(tmp, "tiny-yolo-obj_xnor.weights")
    save_random_weights(XNOR_CFG, weights, seed=SEED)
    names = [f"class_{i:02d}" for i in range(VOC_CLASSES)]
    names_file = os.path.join(tmp, "voc20.names")
    with open(names_file, "w") as f:
        f.write("\n".join(names) + "\n")
    spec, params, _ = detect.build_params(XNOR_CFG, weights, echo=False)
    xnor_convs = [l for l in spec.conv_layers() if l.xnor]
    check(len(xnor_convs) == len(XNOR_SHAPES),
          f"{len(xnor_convs)} XNOR convs in {XNOR_CFG}")
    n_auto = sum(xnor_gemm.auto_prefers_mxu(l.out_h * l.out_w)
                 for l in xnor_convs)
    expect = {"int8": (0, 0), "pallas": (7, 0), "pallas_mxu": (0, 7),
              "auto": (0, n_auto)}
    launches, texts = {}, {}
    for eng in XNOR_IMPLS:
        int8_conv.reset_launch_counts()
        rc, out, _ = run_cli(["detector", "test", names_file, XNOR_CFG,
                              weights, IMAGE, "-xnor_kernel", eng,
                              "-dont_show", "-thresh", XNOR_THRESH, "-save",
                              os.path.join(tmp, f"pred_xnor_{eng}")])
        got = dict(int8_conv.LAUNCH_COUNTS)
        check(rc == 0, f"detector test -xnor_kernel {eng} exited {rc}")
        counts = (got.get("xnor_gemm", 0), got.get("xnor_gemm_mxu", 0))
        check(counts == expect[eng] and sum(got.values()) == sum(counts),
              f"-xnor_kernel {eng}: launches {got} in one forward, expected "
              f"xnor_gemm, xnor_gemm_mxu = {expect[eng]}")
        launches[eng] = counts
        texts[eng] = detection_text(out)
        predicted = [l for l in out.splitlines() if "Predicted in" in l][0]
        say("xnor", f"CLI -xnor_kernel {eng}: {predicted}; launches in one "
            f"forward: xnor_gemm {counts[0]}, xnor_gemm_mxu {counts[1]}; "
            f"{len(texts[eng].splitlines())} detection lines")
    for eng in XNOR_IMPLS[1:]:
        check_same_lines(texts[eng], texts["int8"],
                         f"detection lines of -xnor_kernel {eng} and int8")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        plain_text = detect.run(names, XNOR_CFG, weights, IMAGE,
                                thresh=float(XNOR_THRESH),
                                save_path=os.path.join(tmp, "pred_xplain"),
                                int8_impl="plain", xnor_impl="pallas",
                                device="cuda")
    check_same_lines(plain_text.rstrip("\n"), texts["int8"],
                     "detection lines of the plain path and of int8")
    say("xnor", "detection lines of the four engines and of the plain path "
        "are identical")

    preds = {eng: network.Predictor(spec, params, device="cuda",
                                    xnor_impl=eng) for eng in XNOR_IMPLS}
    for eng in ("pallas", "pallas_mxu"):
        preds[f"{eng} plain"] = network.Predictor(
            spec, params, device="cuda", xnor_impl=eng, int8_impl="plain")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    heads = {name: pred(x) for name, pred in preds.items()}
    check_region_heads(heads["int8"], "xnor int8 engine")
    for name, h in heads.items():
        check(torch.equal(h[0].data, heads["int8"][0].data),
              f"xnor head map of {name} != that of the dense engine")
    say("xnor", f"head maps of {', '.join(heads)} are equal")
    times = {eng: forward_ms(preds[eng], x) for eng in XNOR_IMPLS}
    say("xnor", "warm b=1 forward: " + ", ".join(
        f"{eng} {ms:.3f} ms" for eng, ms in times.items())
        + " (median, host clock, synchronised)")
    return {"pallas": launches["pallas"][0],
            "pallas_mxu": launches["pallas_mxu"][1]}


# ---------------------------------------------------------------------------
# Phase 8: the serving pipeline
# ---------------------------------------------------------------------------


def sparse_head_biases(spec, params, obj_bias: float):
    """bench.py's ``sparse_head_biases``, copied, with the objectness bias as
    an argument: damp each head conv's weights and biases x0.02 and set its
    anchors' objectness (t0) biases to ``obj_bias``, so random weights give
    a sparse set of candidates. Works on unfused and fused host params."""
    for l in spec.layers:
        if isinstance(l, (YoloSpec, RegionSpec)):
            conv = spec.layers[l.index - 1]
            if not isinstance(conv, ConvSpec):
                continue
            p = params[conv.index]
            entries = l.out_c // l.n
            p["weights"] = np.asarray(p["weights"]) * 0.02
            b = np.asarray(p["biases"]).copy() * 0.02
            obj_entry = 4 if isinstance(l, YoloSpec) else l.coords
            for a in range(l.n):
                b[a * entries + obj_entry] = obj_bias
            p["biases"] = b
    return params


def _obj_entry(l) -> int:
    return 4 if isinstance(l, YoloSpec) else l.coords


def calibrate_obj_bias(cfg: str, frame, quantized: bool, kw: dict,
                       thresh: float = PIPE_THRESH,
                       target: int = TARGET_LIVE) -> float:
    """The objectness bias that leaves about ``target`` candidates of
    ``frame`` above ``thresh`` (detector map's by default) in one mode (an
    int8 trunk feeds its heads other features than the fp32 one): one
    forward with the bias
    at 0 gives each candidate's objectness logit and best class score, then
    a bisection on the bias counts the candidates the decode would keep."""
    spec, params, mode = detect.build_params(cfg, None, quantized=quantized,
                                             seed=SEED, echo=False)
    sparse_head_biases(spec, params, 0.0)
    pred = network.Predictor(spec, params, mode, device="cuda", **kw)
    x = im_io.resize_image(frame.astype(np.float32) / np.float32(255),
                           spec.net.w, spec.net.h)[None]
    zs, scores, yolo = [], [], []
    for h, l in zip(pred(x), pred.head_specs()):
        d = h.data[0].double().cpu().numpy()
        e = _obj_entry(l)
        p = np.clip(d[..., e], 1e-15, 1 - 1e-15)
        zs.append(np.log(p / (1 - p)).ravel())
        scores.append(d[..., e + 1:].max(-1).ravel())
        yolo.append(np.full(p.size, isinstance(l, YoloSpec)))
    z, best, yolo = map(np.concatenate, (zs, scores, yolo))
    del pred

    def live(bias):
        obj = 1 / (1 + np.exp(-(z + bias)))
        return int(((obj * best > thresh)
                    & (~yolo | (obj > thresh))).sum())

    lo, hi = -60.0, 60.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if live(mid) < target else (lo, mid)
    return float(np.float32(hi))


def _frames(seed: int, n: int, h: int = FRAME_H, w: int = FRAME_W):
    return (np.random.RandomState(seed).rand(n, h, w, 3) * 255).astype(
        np.uint8)


def _lines(dets, names, w: int, h: int) -> list:
    return post_boxes.format_detections(dets, names, PIPE_THRESH, w,
                                        h).splitlines()


_LINE = re.compile(r"^(.*): (\d+)%(?:\t\(left_x:\s*(-?\d+)\s+top_y:\s*"
                   r"(-?\d+)\s+width:\s*(-?\d+)\s+height:\s*(-?\d+)\))?$")


def check_near_lines(got: list, want: list, what: str) -> tuple:
    """Detection lines ``got`` against ``want`` as multisets: every line
    identical, or paired with one of the same class and percentage whose box
    fields are each within one count. Both are F7 noise of the device decode
    (CUDA's expf against the host's): a box field rounds across a print
    boundary, or two boxes with near-equal left edges print in the other
    order (the print sorts by left edge). Fails if the counts differ, a line
    has no such partner, or more than 1% of the lines are near; returns
    (near lines, lines printed at another position)."""
    check(len(got) == len(want),
          f"{what}: {len(got)} against {len(want)} detection lines")
    moved = sum(a != b for a, b in zip(got, want))
    ca, cb = collections.Counter(got), collections.Counter(want)
    rest_a, rest_b = list((ca - cb).elements()), list((cb - ca).elements())

    def fields(line):
        m = _LINE.match(line)
        if m is None or m.group(3) is None:
            return None
        return m.group(1, 2), [int(v) for v in m.group(3, 4, 5, 6)]

    for line in rest_a:
        fa = fields(line)
        partner = next((j for j, other in enumerate(rest_b)
                        if fa is not None and fields(other) is not None
                        and fields(other)[0] == fa[0]
                        and all(abs(x - y) <= 1
                                for x, y in zip(fa[1], fields(other)[1]))),
                       None)
        if partner is None:
            print(f"{what}: no partner for {line!r} in {rest_b[:5]!r}",
                  file=sys.stderr)
        check(partner is not None,
              f"{what}: a line differs beyond a print-boundary count")
        rest_b.pop(partner)
    check(len(rest_a) <= max(1, len(want) // 100),
          f"{what}: {len(rest_a)} of {len(want)} lines off by a count")
    return len(rest_a), moved


def _bits(t):
    return t.contiguous().view(torch.int32)


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median host wall time of ``fn`` (which ends on the host)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def busy_ms(fn, wall: float) -> float:
    """Device time of one call of ``fn``, queued behind a device sleep longer
    than the host takes to issue it (``wall`` ms), so no operation waits for
    the host: what the device needs when it is never starved. One call: the
    eager program's launches fill most of the card's queue of pending
    launches, and a host blocked on a full queue would starve it."""
    cycles = int(max(SLEEP_CYCLES, 2 * wall * 1e-3 * 2.0e9))
    with torch.inference_mode():
        return event_ms(fn, iters=1, warmup=1, sleep_cycles=cycles)


def _nms_packed_input(dev, b: int, k: int, c: int):
    """A packed [B, K, 5 + C] candidate buffer: clustered boxes (overlap
    galore), quantized probs (exact ties galore), trailing zero rows."""
    rng = np.random.RandomState(SEED + k + c)
    boxes = rng.rand(b, k, 4).astype(np.float32)
    boxes[..., 2:] = 0.05 + 0.3 * boxes[..., 2:]
    centers = rng.rand(b, k // 8, 2)
    which = rng.randint(0, k // 8, (b, k))
    boxes[..., :2] = (np.take_along_axis(centers, which[..., None], 1)
                      + 0.02 * rng.randn(b, k, 2))
    probs = rng.rand(b, k, c).astype(np.float32)
    probs[probs < 0.6] = 0.0
    probs = (np.round(probs * 8) / 8).astype(np.float32)
    probs[:, k - k // 5:] = 0.0
    return torch.from_numpy(np.concatenate(
        [boxes, np.ones((b, k, 1), np.float32), probs], axis=-1)).to(dev)


def order_bound(b: int, k: int, c: int) -> tuple:
    """K7's least time: boxes and probs read, bit rows, order, rank_has_work
    and perm written; the IoU's 11 float32 operations a pair (min, max and
    a subtraction per axis, the product, sum and difference of areas, the
    division, the comparison) at the float32 peak."""
    w = -(-k // 32)
    return bound(4 * (b * k * 4 + b * k * c) + 4 * (b * k * w + b * c * k
                                                     + b * k) + 8 * b * k,
                 11.0 * b * k * k, PEAK_F32_FLOPS)


def walk_bound(ins, probs) -> tuple:
    """The walk's least time: each input read once, the output written once;
    its operations (an and-not per row word and live rank) are far below
    the bytes' time."""
    over, order, rhw = ins[:3]
    return bound(4 * (over.numel() + order.numel() + rhw.numel()
                      + 2 * probs.numel()), 0.0)


def _same(got, want) -> bool:
    return all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int8), b.contiguous().view(torch.int8))
        for a, b in zip(got, want))


def _plain_nms_packed(packed, thresh: float):
    """``device_nms.nms_packed`` with both kernels' plain versions."""
    boxes, probs = packed[..., :4], packed[..., 5:]
    ins = nms_order.nms_order_plain(boxes, probs, thresh)
    new = nms_walk.nms_walk_plain(*ins[:3], probs)
    out = torch.cat([packed[..., :5], new], dim=-1)
    return torch.take_along_dim(out, ins[3][..., None], dim=1)


def peak_mb(fn) -> float:
    """Device memory ``fn`` allocates at its peak beyond what was allocated
    before it, in MB (``torch.cuda.max_memory_allocated``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 1e6


def phase_nms_kernels() -> list:
    """K7 (``nms_order``) and the rank walk against their plain versions, bit
    for bit, at detector map's K (1024), the pipeline's default (256) and
    the device-NMS ceiling (4096), C = 80, B = 8, and at C = 20, on the
    packed buffer's views; each timed beside its bound and its plain
    version. Then the peak memory of one ``nms_packed`` at B = 8, K = 4096,
    kernels against plain versions."""
    dev = torch.device("cuda")
    rows = []
    for b, k, c in NMS_SHAPES + NMS_C20_SHAPES:
        packed = _nms_packed_input(dev, b, k, c)
        boxes, probs = packed[..., :4], packed[..., 5:]
        ins = nms_order.nms_order_cuda(boxes, probs, PIPE_NMS)
        want = nms_order.nms_order_plain(boxes, probs, PIPE_NMS)
        torch.cuda.synchronize()
        check(_same(ins, want), f"nms_order != plain at B={b} K={k} C={c}")
        out = nms_walk.nms_walk_cuda(*ins[:3], probs)
        ref = nms_walk.nms_walk_plain(*ins[:3], probs)
        torch.cuda.synchronize()
        check(torch.equal(_bits(out), _bits(ref)),
              f"nms_walk != plain at B={b} K={k} C={c}")
        rhw = ins[2]
        live = int((rhw > 0).sum(1).max())
        nonzero = int((probs != 0).sum(1).max())
        o_ms = event_ms(lambda: nms_order.nms_order_cuda(boxes, probs,
                                                         PIPE_NMS))
        o_plain = event_ms(lambda: nms_order.nms_order_plain(
            boxes, probs, PIPE_NMS), iters=3, warmup=1)
        w_ms = event_ms(lambda: nms_walk.nms_walk_cuda(*ins[:3], probs))
        # the plain walk reads its stop rank on the host: its time is its
        # host-bound loop's
        w_plain = event_ms(lambda: nms_walk.nms_walk_plain(*ins[:3], probs),
                           iters=2, warmup=1)
        ob_ms, ob_by = order_bound(b, k, c)
        wb_ms, wb_by = walk_bound(ins, probs)
        suppressed = int((ref == 0).sum() - (probs == 0).sum())
        say("pipeline", f"B={b} K={k} C={c} ({live} live ranks, at most "
            f"{nonzero} nonzero probs of a class, {suppressed} suppressed): "
            f"nms_order bit-identical to plain, {o_ms:.4f} ms (plain "
            f"{o_plain:.3f}), bound {ob_ms * 1e3:.2f} us ({ob_by}), "
            f"{100 * ob_ms / o_ms:.1f}%; nms_walk bit-identical to plain, "
            f"{w_ms:.4f} ms (plain {w_plain:.2f}), bound "
            f"{wb_ms * 1e3:.2f} us ({wb_by}), {100 * wb_ms / w_ms:.1f}%")
        rows.append({"shape": [b, k, c], "live_ranks": live,
                     "suppressed": suppressed, "max_abs_err": 0.0,
                     "nms_order": {"ms": o_ms, "plain_ms": o_plain,
                                   "bound_ms": ob_ms, "bound_by": ob_by},
                     "nms_walk": {"ms": w_ms, "plain_ms": w_plain,
                                  "bound_ms": wb_ms, "bound_by": wb_by}})
        del ins, want, out, ref
    b, k, c = NMS_SHAPES[-1]
    packed = _nms_packed_input(dev, b, k, c)
    kernels = peak_mb(lambda: device_nms.nms_packed(packed, PIPE_NMS))
    plain = peak_mb(lambda: _plain_nms_packed(packed, PIPE_NMS))
    say("pipeline", f"peak device memory of one nms_packed at B={b} K={k} "
        f"C={c}: {kernels:.1f} MB on the kernels, {plain:.1f} MB on the "
        "plain versions")
    rows.append({"peak_mb": {"shape": [b, k, c], "kernels": kernels,
                             "plain": plain}})
    return rows


# the (B, K, C) of each NMS stage timed in phase 8, and its row: its device
# operations are counted after the last phase in a process of their own, as
# torch.profiler sessions in this one lost kernels after a few (phase 11
# counts K6's launches under one)
_NMS_STAGES: list = []


def nms_stage(pipe, x) -> dict:
    """The NMS stage of ``pipe`` (eager) on the device batch ``x``: K7, the
    walk and ``nms_packed`` timed on the packed buffer the decode gives, and
    K7's plain version (the PyTorch ops it replaced) beside them."""
    counted = dict(int8_conv.LAUNCH_COUNTS)     # these launches do not count
    with torch.inference_mode():
        heads = [h.data for h in pipe._fwd(pipe.params, pipe.ingest(x))[0]]
        packed = pipe._decoder.packed(heads)
        boxes, probs = packed[..., :4], packed[..., 5:]
        ins = nms_order.nms_order_cuda(boxes, probs, PIPE_NMS)
        b, k, c = probs.shape
        row = {"shape": [b, k, c],
               "live_ranks": int((ins[2] > 0).sum(1).max()),
               "nonzero": int((probs != 0).sum(1).max()),
               "nms_order_ms": event_ms(lambda: nms_order.nms_order_cuda(
                   boxes, probs, PIPE_NMS)),
               "nms_order_plain_ms": event_ms(
                   lambda: nms_order.nms_order_plain(boxes, probs, PIPE_NMS),
                   iters=3, warmup=1),
               "nms_walk_ms": event_ms(lambda: nms_walk.nms_walk_cuda(
                   *ins[:3], probs)),
               "stage_ms": event_ms(lambda: device_nms.nms_packed(
                   packed, PIPE_NMS))}
        row["nms_order_bound_ms"], _ = order_bound(b, k, c)
        row["nms_walk_bound_ms"], _ = walk_bound(ins, probs)
    int8_conv.LAUNCH_COUNTS.clear()
    int8_conv.LAUNCH_COUNTS.update(counted)
    _NMS_STAGES.append(row)
    return row


def count_nms_ops(shapes) -> list:
    """(device operations, sorts) of one ``nms_packed`` on a packed buffer
    of each (B, K, C) in ``shapes``, under torch.profiler: for a process of
    its own (``phase_nms_ops``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    device_nms.load_kernels(dev)
    out = []
    for b, k, c in shapes:
        packed = _nms_packed_input(dev, b, k, c)
        with torch.inference_mode():
            device_nms.nms_packed(packed, PIPE_NMS)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                device_nms.nms_packed(packed, PIPE_NMS)
                torch.cuda.synchronize()
        ev = prof.events()
        out.append([sum(e.device_type == DeviceType.CUDA for e in ev),
                    sum(e.name in ("aten::sort", "aten::argsort")
                        for e in ev)])
    return out


def phase_nms_ops() -> None:
    """The device operations of each NMS stage phase 8 timed (one
    ``nms_packed`` on a buffer of its shape; the count does not follow the
    data), counted in a fresh process; no sort may run in it."""
    shapes = [tuple(row["shape"]) for row in _NMS_STAGES]
    res = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke as cs; print(json.du"
         f"mps(cs.count_nms_ops({shapes!r})))"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, "counting the NMS stage's operations failed: "
          + res.stderr[-2000:])
    counts = json.loads(res.stdout.strip().splitlines()[-1])
    for row, (ops, sorts) in zip(_NMS_STAGES, counts):
        row["stage_ops"], row["stage_sorts"] = ops, sorts
        check(ops > 0 and sorts == 0,
              f"NMS stage at {tuple(row['shape'])}: {ops} device operations, "
              f"{sorts} sorts")
        say("pipeline", f"NMS stage at {tuple(row['shape'])}: {ops} device "
            "operations, no sort (one nms_packed under torch.profiler, in a "
            "process of its own)")
    _NMS_STAGES.clear()


def _pipeline_mode(name: str, cfg: str, quantized: bool, kw: dict,
                   kernel, bias: float, frames, tmp: str, names) -> dict:
    """One mode of the pipeline: graph replay against eager, detections
    against ``detect_image``, ``serve_scan`` against per-frame calls, walls
    and device time, at b=1 and b=8."""
    spec, params, mode = detect.build_params(cfg, None, quantized=quantized,
                                             seed=SEED, echo=False)
    sparse_head_biases(spec, params, bias)
    args = dict(thresh=PIPE_THRESH, nms=PIPE_NMS, k=PIPE_K,
                device_nms=True, device="cuda", **kw)
    int8_conv.reset_launch_counts()
    graphed = pipeline.DetectionPipeline(spec, params, mode, **args)
    eager = pipeline.DetectionPipeline(spec, graphed.params, mode,
                                       cuda_graph=False, **args)
    row = {"mode": name}
    for b in (1, 8):
        x = frames[:b]
        a, e = graphed.raw(x), eager.raw(x)
        torch.cuda.synchronize()
        check(torch.equal(_bits(a), _bits(e)),
              f"{name} b={b}: graph replay != eager")
        other = np.ascontiguousarray(frames[::-1][:b])
        check(torch.equal(_bits(graphed.raw(other)), _bits(eager.raw(other))),
              f"{name} b={b}: replay on other frames != eager")
        row[f"b{b}_captured_ms"] = wall_ms(
            lambda: pipeline._fetch_packed(graphed.raw(x)))
        row[f"b{b}_eager_ms"] = wall_ms(
            lambda: pipeline._fetch_packed(eager.raw(x)), iters=10)
        xd = torch.from_numpy(x).cuda()
        g = graphed._graphs[(tuple(x.shape), torch.uint8, False)]
        row[f"b{b}_busy_graph_ms"] = busy_ms(g.graph.replay,
                                             row[f"b{b}_captured_ms"])
        row[f"b{b}_busy_eager_ms"] = busy_ms(lambda: eager.run(xd),
                                             row[f"b{b}_eager_ms"])
        for kind in ("captured", "eager"):
            busy = row[f"b{b}_busy_{'graph' if kind == 'captured' else kind}"
                       "_ms"]
            row[f"b{b}_{kind}_idle"] = 1 - busy / row[f"b{b}_{kind}_ms"]
        say("pipeline", f"{name} b={b}: graph replay bit-identical to eager "
            f"(packed {tuple(a.shape)}); wall per batch (uint8 {FRAME_W}x"
            f"{FRAME_H} in, packed buffer out) captured "
            f"{row[f'b{b}_captured_ms']:.3f} ms, eager "
            f"{row[f'b{b}_eager_ms']:.3f} ms; device time "
            f"{row[f'b{b}_busy_graph_ms']:.3f} / "
            f"{row[f'b{b}_busy_eager_ms']:.3f} ms; device idle "
            f"{100 * row[f'b{b}_captured_idle']:.1f}% / "
            f"{100 * row[f'b{b}_eager_idle']:.1f}% of the wall")
        if name in NMS_STAGE_MODES:
            st = row[f"b{b}_nms"] = nms_stage(eager, xd)
            say("pipeline", f"{name} b={b}: NMS stage at {tuple(st['shape'])}"
                f" ({st['live_ranks']} live ranks, at most {st['nonzero']} "
                f"nonzero probs of a class): nms_packed {st['stage_ms']:.4f} "
                f"ms; nms_order "
                f"{st['nms_order_ms']:.4f} ms (bound "
                f"{st['nms_order_bound_ms'] * 1e3:.2f} us; plain "
                f"{st['nms_order_plain_ms']:.3f} ms), nms_walk "
                f"{st['nms_walk_ms']:.4f} ms (bound "
                f"{st['nms_walk_bound_ms'] * 1e3:.2f} us)")
    launches = dict(int8_conv.LAUNCH_COUNTS)
    if kernel is not None:
        check(launches.get(kernel, 0) > 0,
              f"{name}: {kernel} was not launched in the captures")
    for k in ("nms_order", "nms_walk"):
        check(launches.get(k, 0) > 0,
              f"{name}: {k} was not launched in the captures")
    row["launches_at_capture"] = launches

    # detections against the host path (eager forward, host decode and NMS)
    # on frames at the net's size: the host resize of detect_image is a
    # native build that contracts its lerps into FMAs, one ULP off the
    # device resize, and the int8 trunk's quantizers carry such an ULP into
    # other detections (F7)
    from PIL import Image
    net_frames = _frames(SEED + 1, len(frames), spec.net.h, spec.net.w)
    pred = network.Predictor(spec, params, mode, device="cuda", **kw)
    got = graphed(net_frames)
    if kw.get("compute_dtype") == torch.bfloat16:
        # -bf16's float convs sum in float32 in an order fixed by the
        # layer's shape (K6, csrc/bf16_conv.cu): each frame of the b=8 batch
        # prints the lines it prints alone
        one = [graphed(net_frames[i:i + 1])[0] for i in range(len(frames))]
        row["frames_b8_unlike_b1"] = sum(
            _lines(a, names, spec.net.w, spec.net.h)
            != _lines(b, names, spec.net.w, spec.net.h)
            for a, b in zip(got, one))
        check(row["frames_b8_unlike_b1"] == 0,
              f"{name}: the lines of {row['frames_b8_unlike_b1']} frames "
              "differ between b=8 and b=1")
    n_lines = n_near = n_moved = 0
    for i, im in enumerate(net_frames):
        path = os.path.join(tmp, f"net_frame{i}.png")
        Image.fromarray(im).save(path)
        host, _, _ = detect.detect_image(pred, spec, path, PIPE_THRESH,
                                         PIPE_NMS, names)
        want = _lines(host, names, spec.net.w, spec.net.h)
        near, moved = check_near_lines(
            _lines(got[i], names, spec.net.w, spec.net.h), want,
            f"{name}: pipeline and detect_image detections of frame {i}")
        n_near, n_moved = n_near + near, n_moved + moved
        n_lines += len(want)
    check(n_lines > 0, f"{name}: no detection line at thresh {PIPE_THRESH}")
    row["detection_lines"] = n_lines
    row["lines_off_by_a_count"] = n_near
    row["lines_printed_elsewhere"] = n_moved
    final = graphed
    while final._promoted is not None:
        final = final._promoted
    row["k_reached"] = final.k
    batch = ("b=8, each frame's lines equal to its own b=1 lines"
             if "frames_b8_unlike_b1" in row else "b=8")
    say("pipeline", f"{name}: detections of 8 net-size frames ({batch}) "
        f"equal detect_image's ({n_lines} lines at thresh {PIPE_THRESH}; {n_near} "
        f"with a box field one count off, {n_moved} printed at another "
        f"position); K reached {final.k}")

    scanned = graphed.serve_scan(frames)
    for i, d in enumerate(scanned):
        one = graphed(frames[i:i + 1])[0]
        check(np.array_equal(d.bbox, one.bbox)
              and np.array_equal(d.prob, one.prob),
              f"{name}: serve_scan frame {i} != its own call")
    row["serve_scan_ms_frame"] = wall_ms(
        lambda: graphed.serve_scan(frames), iters=5) / len(frames)
    say("pipeline", f"{name}: serve_scan over an 8-frame ring equals the "
        f"per-frame calls; {row['serve_scan_ms_frame']:.3f} ms a frame "
        "(host finish included)")
    return row


def _map_dataset(tmp: str, names: list) -> str:
    """16 synthetic PNGs with 1-3 random labels each, and their .data."""
    from PIL import Image
    root = os.path.join(tmp, "mapds")
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    rng = np.random.RandomState(SEED)
    paths = []
    for i, im in enumerate(_frames(SEED + 100, MAP_IMAGES)):
        p = os.path.join(root, "images", f"im{i}.png")
        Image.fromarray(im).save(p)
        paths.append(p)
        with open(os.path.join(root, "labels", f"im{i}.txt"), "w") as f:
            for _ in range(rng.randint(1, 4)):
                x, y = rng.uniform(0.2, 0.8, 2)
                w, h = rng.uniform(0.1, 0.4, 2)
                f.write(f"{rng.randint(0, N_CLASSES)} {x:.6f} {y:.6f} "
                        f"{w:.6f} {h:.6f}\n")
    with open(os.path.join(root, "valid.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    with open(os.path.join(root, "coco.names"), "w") as f:
        f.write("\n".join(names) + "\n")
    data = os.path.join(root, "map.data")
    with open(data, "w") as f:
        f.write(f"classes={N_CLASSES}\nvalid={root}/valid.txt\n"
                f"names={root}/coco.names\n")
    return data


def _report(text: str) -> list:
    out, on = [], False
    for line in text.splitlines():
        if "detections_count" in line:
            on = True
        if on:
            out.append(line.rstrip())
        if "mean average precision" in line:
            break
    return out


def phase_map(tmp: str, bias: float, names: list) -> dict:
    """``detector map -quantized`` through the CLI on yolov3-416 over 16
    synthetic PNGs: host NMS against ``-device_nms`` from a small ``-k``
    (auto-grow), identical reports."""
    data = _map_dataset(tmp, names)
    spec = parse_network_cfg(CFG, batch=1, echo_table=False)
    params = sparse_head_biases(spec, random_params(spec, seed=SEED), bias)
    weights = os.path.join(tmp, "yolov3-sparse.weights")
    save_weights(spec, params, weights)

    spec, params, mode = detect.build_params(CFG, weights, quantized=True,
                                             echo=False)
    counter = pipeline.DetectionPipeline(
        spec, params, mode, thresh=PIPE_THRESH, nms=0, k=10647)
    imgs = np.stack([im_io.resize_image(im_io.load_image(p, 3), 416, 416)
                     for p in sorted(
                         glob.glob(os.path.join(tmp, "mapds", "images",
                                                "*.png")))])
    live = [d.n for d in counter(imgs)]
    del counter
    say("pipeline", f"map images: live candidates at thresh {PIPE_THRESH} "
        f"(head objectness bias {bias:.4f}): min {min(live)}, median "
        f"{int(np.median(live))}, max {max(live)} of 10647")

    out = {"live_candidates": live}
    reports = {}
    for tag, extra in (("host_nms", []),
                       ("device_nms", ["-device_nms", "-k", "64"])):
        int8_conv.reset_launch_counts()
        t0 = time.perf_counter()
        rc, stdout, stderr = run_cli(["detector", "map", data, CFG, weights,
                                      "-quantized"] + extra)
        wall = time.perf_counter() - t0
        check(rc == 0, f"detector map ({tag}) exited {rc}")
        reports[tag] = _report(stdout)
        check(len(reports[tag]) > N_CLASSES,
              f"detector map ({tag}) printed no report")
        det_s = float(stderr.split("Total Detection Time: ")[1].split()[0])
        grown = [int(l.split("with K=")[1].split()[0])
                 for l in stderr.splitlines() if "re-running batch with K=" in l]
        out[tag] = {"img_s": MAP_IMAGES / det_s, "detection_s": det_s,
                    "cli_s": wall, "k_reached": max(grown, default=None),
                    "launches": dict(int8_conv.LAUNCH_COUNTS)}
        say("pipeline", f"detector map -quantized ({tag}): "
            f"{MAP_IMAGES / det_s:.2f} img/s over {MAP_IMAGES} images "
            f"(Total Detection Time {det_s:.3f} s, first captures included; "
            f"CLI call {wall:.2f} s); auto-grow reached K="
            f"{out[tag]['k_reached']}; {reports[tag][0]}")
    check(reports["host_nms"] == reports["device_nms"],
          "detector map: host NMS and -device_nms reports differ")
    check(out["device_nms"]["k_reached"] is not None,
          "detector map -device_nms -k 64 did not auto-grow")
    say("pipeline", "detector map: host NMS and -device_nms print identical "
        f"reports ({len(reports['host_nms'])} lines)")
    for k in ("nms_order", "nms_walk"):
        out[f"{k}_launches"] = out["device_nms"]["launches"].get(k, 0)
    return out


def phase_pipeline(tmp: str) -> dict:
    names = [f"class_{i:02d}" for i in range(N_CLASSES)]
    voc = [f"class_{i:02d}" for i in range(VOC_CLASSES)]
    nms_rows = phase_nms_kernels()
    frames = _frames(SEED, 8)
    modes, biases = [], {}
    for name, (cfg, quantized, kw, kernel) in PIPE_MODES.items():
        biases[name] = calibrate_obj_bias(cfg, frames[0], quantized, kw)
        modes.append(_pipeline_mode(
            name, cfg, quantized, kw, kernel, biases[name], frames, tmp,
            names if cfg == CFG else voc))
        modes[-1]["obj_bias"] = biases[name]
    mapped = phase_map(tmp, biases["yolov3 int8"], names)
    shapes = [r for r in nms_rows if "shape" in r]
    stages = {f"{m['mode']} b={b}": m[f"b{b}_nms"] for m in modes
              for b in (1, 8) if f"b{b}_nms" in m}
    # not TPU kernels: each replaces XLA ops of nms_probs_with_order; sums
    # over the synthetic shapes, the pipeline's own shapes beside them
    kernels = [{
        "name": k, "kernel": k, "route": "cuda", "source": source,
        "replaces": replaces, "launches": mapped[f"{k}_launches"],
        "max_abs_err": 0.0,
        "ms": sum(r[k]["ms"] for r in shapes),
        "plain_ms": sum(r[k]["plain_ms"] for r in shapes),
        **row_bound([r[k] for r in shapes]), "library_ms": None,
        "shapes": [{"shape": r["shape"], **r[k]} for r in shapes],
        "pipeline": {n: {"ms": st[f"{k}_ms"], "bound_ms": st[f"{k}_bound_ms"],
                         "live_ranks": st["live_ranks"]}
                     for n, st in stages.items()}}
        for k, source, replaces in (
            ("nms_order", ORDER_SOURCE, ORDER_REPLACES),
            ("nms_walk", NMS_SOURCE, NMS_REPLACES))]
    return {"nms_kernels": kernels, "nms_shapes": nms_rows,
            "modes": modes, "map": mapped}


# ---------------------------------------------------------------------------
# Phase 9: the precision modes
# ---------------------------------------------------------------------------


def _form_operands(dev, seed: int, shape, x_form: str):
    """One int8 conv class's operands with the input in ``x_form``."""
    b, h, w, c, m, ks, _, _ = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(b, h, w, c) * 4).astype(
        np.float32)).to(dev)
    wt = torch.from_numpy(rng.randint(-127, 128, (m, ks, ks, c)).astype(
        np.int8)).to(dev)
    bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
    xin = (int8_conv.quantize_i8(x, IN_MULT) if x_form == "int8"
           else x.to(_DTYPES[x_form]))
    return xin, wt, bias


def _run_form(form: str, plain: bool, xin, wt, bias, s: int, pad: int,
              act: str = "leaky"):
    """K1 (or its plain twin) in ``form`` on ``xin``."""
    x_form, semantics, store = form.split("/")
    scale = int8_conv.alpha_f32(IN_MULT, W_MULT,
                                32 if semantics == "cpu" else 1)
    kw = dict(semantics=semantics, out_dtype=_DTYPES[store],
              out_mult=STORE_MULT if store == "int8" else None)
    if x_form == "int8":
        fn = (int8_conv.conv2d_int8_plain if plain
              else int8_conv.conv2d_int8_cuda)
        return fn(xin, wt, bias, scale, s, pad, act, **kw)
    fn = (int8_conv.conv2d_int8_f32_plain if plain
          else int8_conv.conv2d_int8_f32_cuda)
    return fn(xin, wt, bias, IN_MULT, scale, s, pad, act, **kw)


def phase_precision_kernels() -> dict:
    """K1's new forms against their plain twins, bit for bit, leaky and
    linear: every form at yolov3-416's 15 int8 classes, the gpu epilogue at
    the gpu set's 6 classes. Each path form is timed beside its bound (bytes
    at the form's real widths) and ``torch._int_mm`` on the same product."""
    dev = torch.device("cuda")
    rows = {}
    for form in list(K1_PATH_FORMS) + list(K1_OTHER_FORMS):
        x_form, semantics, store = form.split("/")
        shapes = []
        for i, (label, shape) in enumerate(SHAPES):
            if semantics == "gpu" and label not in GPU_CLASSES:
                continue
            b, h, w, c, m, ks, s, pad = shape
            xin, wt, bias = _form_operands(dev, SEED + i, shape, x_form)
            err = 0.0
            for act in ("leaky", "linear"):
                out = _run_form(form, False, xin, wt, bias, s, pad, act)
                ref = _run_form(form, True, xin, wt, bias, s, pad, act)
                torch.cuda.synchronize()
                check(out.dtype == _DTYPES[store] and torch.equal(out, ref),
                      f"K1 {form} != plain at {label} ({act})")
                err = max(err, float((out.float() - ref.float()).abs().max()))
            row = {"shape": label, "max_abs_err": err}
            if form in K1_PATH_FORMS:
                x8 = (xin if x_form == "int8"
                      else int8_conv.quantize_i8(xin.float(), IN_MULT))
                a = im2col_int8(x8, ks, s, pad)
                wmat = wt.view(m, -1).t()
                row["ms"] = event_ms(lambda: _run_form(
                    form, False, xin, wt, bias, s, pad))
                row["plain_ms"] = event_ms(lambda: _run_form(
                    form, True, xin, wt, bias, s, pad), iters=10)
                row["library_ms"] = event_ms(lambda: torch._int_mm(a, wmat))
                oh, ow = ref.shape[1:3]
                p = b * oh * ow
                row["bound_ms"], row["bound_by"] = bound(
                    xin.element_size() * xin.numel() + wt.numel() + 4 * m
                    + _DTYPES[store].itemsize * p * m,
                    2.0 * p * m * ks * ks * c)
            shapes.append(row)
        rows[form] = shapes
        if form in K1_PATH_FORMS:
            ms = sum(r["ms"] for r in shapes)
            b_ms = sum(r["bound_ms"] for r in shapes)
            say("precision", f"K1 {form} ({K1_PATH_FORMS[form]}): "
                f"bit-identical to plain at {len(shapes)} classes, leaky and "
                f"linear; kernel {ms:.4f} ms summed (per class "
                f"{min(r['ms'] for r in shapes):.4f}-"
                f"{max(r['ms'] for r in shapes):.4f}), plain "
                f"{sum(r['plain_ms'] for r in shapes):.4f}, torch._int_mm "
                f"{sum(r['library_ms'] for r in shapes):.4f} ms; bound "
                f"{b_ms * 1e3:.2f} us, {100 * b_ms / ms:.1f}% of it")
        else:
            say("precision", f"K1 {form}: bit-identical to plain at "
                f"{len(shapes)} classes, leaky and linear")
    return rows


def phase_precision(tmp: str, weights: str, names_file: str,
                    names: list) -> dict:
    """``detector test`` through the CLI in each precision mode: the
    launches of one forward, head maps and detection lines of the kernel
    path equal to the plain path's, and the warm b=1 forward."""
    xnor_weights = os.path.join(tmp, "tiny-yolo-obj_xnor.weights")
    voc = [f"class_{i:02d}" for i in range(VOC_CLASSES)]
    voc_file = os.path.join(tmp, "voc20.names")
    forms: collections.Counter = collections.Counter()
    runs = {}
    for name, (cfg, flags, kw, expect, no_pre) in PRECISION_RUNS.items():
        yolo = cfg == CFG
        thresh = THRESH if yolo else XNOR_THRESH
        wfile, nfile, nlist = ((weights, names_file, names) if yolo
                               else (xnor_weights, voc_file, voc))
        quantized = "-quantized" in flags
        int8_conv.reset_launch_counts()
        rc, out, _ = run_cli(["detector", "test", nfile, cfg, wfile, IMAGE,
                              "-dont_show", "-thresh", thresh, "-save",
                              os.path.join(tmp, "pred_precision")] + flags)
        launches = {k: v for k, v in int8_conv.LAUNCH_COUNTS.items() if v}
        pre = {k: v for k, v in int8_conv.PRE_LAUNCHES.items() if v}
        run_forms = {k: v for k, v in int8_conv.FORM_LAUNCHES.items() if v}
        forms.update(run_forms)
        check(rc == 0, f"detector test {' '.join(flags)} exited {rc}")
        check(launches == expect, f"{name}: launches {launches} in one "
              f"forward, expected {expect}")
        if no_pre:
            check(not pre, f"{name}: launches in front of the int8 convs: "
                  f"{pre}")
        text = detection_text(out)

        spec, params, mode = detect.build_params(cfg, wfile,
                                                 quantized=quantized,
                                                 echo=False)
        plain_impl = ("fused_plain" if kw.get("int8_impl") == "fused"
                      else "plain")
        kernel = network.Predictor(spec, params, mode, device="cuda", **kw)
        plain = network.Predictor(spec, params, mode, device="cuda",
                                  **dict(kw, int8_impl=plain_impl))
        x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(
            np.float32)
        # -bf16 alone: the plain path runs K6's twin (another order of the
        # float32 sums), held at the bf16 limits. -quantized -bf16: K6 on
        # both sides, so K1 is held bit for bit (phase 11 holds K6's convs)
        bf16 = kw.get("compute_dtype") == torch.bfloat16
        near = bf16 and not quantized
        same_k6 = (k6_on_the_plain_path if bf16 and quantized
                   else contextlib.nullcontext)
        hk = kernel(x)
        with same_k6():
            hp = plain(x)
        (check_heads if yolo else check_region_heads)(hk, name)
        for a, b in zip(hk, hp):
            check(a.data.dtype == torch.float32,
                  f"{name} head {a.index}: not float32")
            if not near:
                check(torch.equal(a.data, b.data),
                      f"{name} head {a.index}: kernel path != plain path")
        gap = (check_bf16_heads([(a.data, b.data, a.index)
                                 for a, b in zip(hk, hp)], name)
               if near else None)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()), same_k6():
            plain_text = detect.run(
                nlist, cfg, wfile, IMAGE, thresh=float(thresh),
                quantized=quantized,
                save_path=os.path.join(tmp, "pred_precision_plain"),
                device="cuda", **dict(kw, int8_impl=plain_impl))
        if near:
            unlike = check_bf16_lines(text.splitlines(),
                                      plain_text.splitlines(), name)
            gap["lines_unlike"] = unlike
            say("precision", f"{name}: heads against the plain path (K6's "
                f"twin): at least {100 * gap['within_min']:.4f}% of each "
                f"head within rtol/atol {bf16_conv.HEADS_TOL}, mean at most "
                f"{gap['mean_max']:.3g}, max {gap['max']:.3g}; "
                f"{unlike} of {len(text.splitlines())} detection lines not "
                f"among the plain path's {len(plain_text.splitlines())} "
                f"(limits {100 * BF16_HEADS_WITHIN:.1f}%, "
                f"{bf16_conv.HEADS_MEAN}, {BF16_HEADS_MAX}, "
                f"{100 * BF16_LINES_UNLIKE:.0f}%)")
        else:
            check_same_lines(text, plain_text.rstrip("\n"),
                             f"{name}: detection lines of the kernel and "
                             "the plain path")
        ms = forward_ms(kernel, x)
        runs[name] = {"launches": launches, "pre_launches": pre,
                      "forms": run_forms,
                      "detection_lines": len(text.splitlines()),
                      "forward_ms": ms, "bf16_gap": gap}
        say("precision", f"CLI {' '.join(flags)} on {os.path.basename(cfg)}"
            f": launches in one forward {launches}, K1 forms "
            f"{runs[name]['forms']}, in front of the int8 convs "
            f"{pre or 'none'}; {len(text.splitlines())} detection lines; "
            f"heads and lines of the kernel and the plain path "
            f"{'near (bf16 limits)' if near else 'equal'}"
            f"{' (K6 on both sides)' if bf16 and quantized else ''}; warm "
            f"b=1 forward {ms:.3f} ms (median, host clock, synchronised)")
        del kernel, plain
    for form in K1_PATH_FORMS:
        check(forms[form] > 0, f"K1 {form} was not launched by phase 9")
    return {"runs": runs, "form_launches": dict(forms)}


# ---------------------------------------------------------------------------
# Phase 10: -int8_policy cpu_old and detector calibrate on yolov2-voc-416
# ---------------------------------------------------------------------------


def _old_operands(dev, seed: int, shape):
    """One int8 conv class's int8 input and weights, with biases_quant and
    an output_multipler at quantize_params' scales (q spans the leaky
    branch, zero and the int8 clamp)."""
    b, h, w, c, m, ks, _, _ = shape
    rng = np.random.RandomState(seed)
    x8 = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(
        np.int8)).to(dev)
    wt = torch.from_numpy(rng.randint(-127, 128, (m, ks, ks, c)).astype(
        np.int8)).to(dev)
    bq = torch.from_numpy((rng.randn(m) * 300).astype(np.float32)).to(dev)
    mult = float(np.float32(rng.uniform(0.05, 0.4)) / ks)
    return x8, wt, bq, mult


def _old_conv(plain: bool, x8, wt, bq, mult: float, s: int, pad: int,
              store: str, act: str = "leaky"):
    fn = int8_conv.conv2d_int8_plain if plain else int8_conv.conv2d_int8_cuda
    return fn(x8, wt, bq, mult, s, pad, act, semantics="old",
              out_dtype=OLD_STORES[store])


def phase_old_kernels() -> dict:
    """K1's "old" epilogue against its plain twin, bit for bit, in its three
    stores, leaky and linear, at yolov2-voc-416's 12 int8 conv classes; the
    store the cpu_old path launches at a class timed beside its bound (int8
    in; int8 or float32 out; biases_quant and the multiplier) and
    ``torch._int_mm`` on the same gathered product."""
    dev = torch.device("cuda")
    rows = {form: [] for form in OLD_PATH_FORMS}
    for i, (label, shape, path_store) in enumerate(VOC_OLD_CLASSES):
        b, h, w, c, m, ks, s, pad = shape
        x8, wt, bq, mult = _old_operands(dev, SEED + i, shape)
        err = 0.0
        for store in OLD_STORES:
            for act in ("leaky", "linear"):
                out = _old_conv(False, x8, wt, bq, mult, s, pad, store, act)
                ref = _old_conv(True, x8, wt, bq, mult, s, pad, store, act)
                torch.cuda.synchronize()
                outs, refs = ((out, ref) if store == "f32+int8"
                              else ((out,), (ref,)))
                for o, r in zip(outs, refs):
                    check(o.dtype == r.dtype and torch.equal(o, r),
                          f"K1 int8/old/{store} != plain at {label} ({act})")
                    err = max(err, float((o.float() - r.float()).abs().max()))
        a = im2col_int8(x8, ks, s, pad)
        wmat = wt.view(m, -1).t()
        p = a.shape[0]
        row = {"shape": label, "max_abs_err": err}
        row["ms"] = event_ms(lambda: _old_conv(False, x8, wt, bq, mult, s,
                                               pad, path_store))
        row["plain_ms"] = event_ms(lambda: _old_conv(True, x8, wt, bq, mult,
                                                     s, pad, path_store),
                                   iters=10)
        row["library_ms"] = event_ms(lambda: torch._int_mm(a, wmat))
        row["bound_ms"], row["bound_by"] = bound(
            x8.numel() + wt.numel() + 4 * m + 4
            + _DTYPES[path_store].itemsize * p * m,
            2.0 * p * m * ks * ks * c)
        rows[f"int8/old/{path_store}"].append(row)
        say("old", f"K1 int8/old at {label}: f32, int8 and f32+int8 stores "
            f"bit-identical to plain, leaky and linear; path store "
            f"{path_store}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f}, torch._int_mm {row['library_ms']:.4f} "
            f"ms; bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
    for form, shapes in rows.items():
        ms = sum(r["ms"] for r in shapes)
        b_ms = sum(r["bound_ms"] for r in shapes)
        say("old", f"K1 {form} ({OLD_PATH_FORMS[form]}): {len(shapes)} "
            f"classes, kernel {ms:.4f} ms summed, plain "
            f"{sum(r['plain_ms'] for r in shapes):.4f}, torch._int_mm "
            f"{sum(r['library_ms'] for r in shapes):.4f} ms; bound "
            f"{b_ms * 1e3:.2f} us, {100 * b_ms / ms:.1f}% of it")
    return rows


def check_voc_heads(heads, what: str) -> None:
    check([h.index for h in heads] == [31], f"{what}: head layers")
    check(tuple(heads[0].data.shape) == (1, 13, 13, 5, 5 + VOC_CLASSES),
          f"{what}: head shape {tuple(heads[0].data.shape)}")
    check(bool(torch.isfinite(heads[0].data).all()),
          f"{what}: head has non-finite values")


def _old_detect(tmp: str, weights: str, voc_file: str, voc: list) -> dict:
    """``detector test -quantized -int8_policy cpu_old`` through the CLI:
    launches of one forward, kernel path == plain path (heads and lines),
    the warm forward's wall and device busy."""
    int8_conv.reset_launch_counts()
    rc, out, _ = run_cli(["detector", "test", voc_file, VOC_CFG, weights,
                          IMAGE, "-quantized", "-int8_policy", "cpu_old",
                          "-dont_show", "-thresh", OLD_THRESH, "-save",
                          os.path.join(tmp, "pred_old")])
    launches = {k: v for k, v in int8_conv.LAUNCH_COUNTS.items() if v}
    forms = {k: v for k, v in int8_conv.FORM_LAUNCHES.items() if v}
    pre = {k: v for k, v in int8_conv.PRE_LAUNCHES.items() if v}
    check(rc == 0, f"detector test -int8_policy cpu_old exited {rc}")
    text = detection_text(out)
    spec, params, _ = detect.build_params(VOC_CFG, weights, quantized=True,
                                          echo=False)
    int8_set = network._int8_layer_set(spec, "cpu_old")
    convs = [l.index for l in spec.conv_layers()]
    check(sorted(int8_set) == [i for i in convs if 1 <= i < convs[-1]],
          f"cpu_old int8 set {sorted(int8_set)}")
    check(launches == {"int8_conv": len(int8_set)},
          f"cpu_old: launches {launches} in one forward, expected "
          f"{len(int8_set)} int8_conv")
    check(forms == OLD_EXPECT_FORMS, f"cpu_old: K1 forms {forms}, expected "
          f"{OLD_EXPECT_FORMS}")
    check(len(text.splitlines()) > 0,
          f"cpu_old: no detection line at thresh {OLD_THRESH}")
    kernel = network.Predictor(spec, params, "int8", device="cuda",
                               int8_policy="cpu_old")
    plain = network.Predictor(spec, params, "int8", device="cuda",
                              int8_policy="cpu_old", int8_impl="plain")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    hk, hp = kernel(x), plain(x)
    check_voc_heads(hk, "cpu_old kernel path")
    check(torch.equal(hk[0].data, hp[0].data),
          "cpu_old head: kernel path != plain path")
    with contextlib.redirect_stdout(io.StringIO()):
        dets, im, _ = detect.detect_image(plain, spec, IMAGE,
                                          float(OLD_THRESH), 0.2, voc)
    plain_text = post_boxes.format_detections(dets, voc, float(OLD_THRESH),
                                              im.shape[1], im.shape[0])
    check_same_lines(text, plain_text.rstrip("\n"),
                     "cpu_old detection lines of the kernel and plain path")
    wall = forward_ms(kernel, x)
    xd = torch.from_numpy(x).cuda()
    busy = busy_ms(lambda: kernel(xd), wall)
    say("old", f"CLI -quantized -int8_policy cpu_old on yolov2-voc-416: "
        f"launches in one forward {launches}, K1 forms {forms}, PyTorch "
        f"quantize or copy launches {pre or 'none'} (the layer-0 requant "
        f"is a quantize); {len(text.splitlines())} detection lines at "
        f"thresh {OLD_THRESH}; heads and lines of the kernel and the plain "
        f"path equal; warm b=1 forward {wall:.3f} ms (median, host clock, "
        f"synchronised), device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% of the wall)")
    return {"launches": launches, "forms": forms, "pre_launches": pre,
            "detection_lines": len(text.splitlines()), "forward_ms": wall,
            "busy_ms": busy, "spec": spec, "params": params}


def _old_pipeline(spec, params) -> dict:
    """DetectionPipeline in cpu_old at b=1: graph replay == eager, with K1's
    old form launched inside the capture; walls and device time."""
    args = dict(thresh=PIPE_THRESH, nms=PIPE_NMS, k=PIPE_K, device_nms=True,
                device="cuda", int8_policy="cpu_old")
    int8_conv.reset_launch_counts()
    graphed = pipeline.DetectionPipeline(spec, params, "int8", **args)
    eager = pipeline.DetectionPipeline(spec, graphed.params, "int8",
                                       cuda_graph=False, **args)
    frames = _frames(SEED + 2, 2)
    x, other = frames[:1], frames[1:]
    check(torch.equal(_bits(graphed.raw(x)), _bits(eager.raw(x))),
          "cpu_old pipeline: graph replay != eager")
    check(torch.equal(_bits(graphed.raw(other)), _bits(eager.raw(other))),
          "cpu_old pipeline: replay on another frame != eager")
    forms = {k: v for k, v in int8_conv.FORM_LAUNCHES.items() if v}
    check(set(forms) == set(OLD_EXPECT_FORMS),
          f"cpu_old pipeline: K1 forms {forms} at capture")
    row = {"captured_ms": wall_ms(
        lambda: pipeline._fetch_packed(graphed.raw(x)))}
    row["eager_ms"] = wall_ms(lambda: pipeline._fetch_packed(eager.raw(x)),
                              iters=10)
    g = graphed._graphs[(tuple(x.shape), torch.uint8, False)]
    row["busy_graph_ms"] = busy_ms(g.graph.replay, row["captured_ms"])
    xd = torch.from_numpy(x).cuda()
    row["busy_eager_ms"] = busy_ms(lambda: eager.run(xd), row["eager_ms"])
    say("old", f"DetectionPipeline cpu_old b=1: graph replay bit-identical "
        f"to eager (K1 forms at capture {forms}); wall per frame (uint8 "
        f"{FRAME_W}x{FRAME_H} in, packed buffer out) captured "
        f"{row['captured_ms']:.3f} ms, eager {row['eager_ms']:.3f} ms; "
        f"device time {row['busy_graph_ms']:.3f} / "
        f"{row['busy_eager_ms']:.3f} ms")
    return row


def _calib_dataset(tmp: str) -> str:
    """CALIB_IMAGES random PNGs (as tests/test_calibrate_parity.py builds
    its dataset, at 320x400, which the app resizes to 416x416), their valid
    list and .data."""
    from PIL import Image
    root = os.path.join(tmp, "calibds")
    os.makedirs(root)
    rng = np.random.RandomState(SEED)
    paths = []
    for i in range(CALIB_IMAGES):
        p = os.path.join(root, f"im{i}.png")
        Image.fromarray((rng.rand(320, 400, 3) * 255).astype(np.uint8)).save(
            p)
        paths.append(p)
    with open(os.path.join(root, "valid.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    data = os.path.join(root, "voc.data")
    with open(data, "w") as f:
        f.write(f"classes={VOC_CLASSES}\nvalid={root}/valid.txt\n")
    return data


def _old_calibrate(tmp: str, weights: str) -> dict:
    """``detector calibrate`` through the CLI (device method, 8 images); the
    host and device methods on the same card activations over the first 2
    images, within 0.02 of the host's multiplier; ms per image of each; the
    written line parsed back by the port's cfg."""
    from yolo2_light_tpu_torch.apps import calibrate
    data = _calib_dataset(tmp)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        rc, out, err = run_cli(["detector", "calibrate", data, VOC_CFG,
                                weights, "-input_calibration",
                                str(CALIB_IMAGES), "-calib_method",
                                "device"])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"detector calibrate exited {rc}")
        with open(os.path.join(tmp, "input_calibration.txt")) as f:
            line = f.read()
    finally:
        os.chdir(cwd)
    check(out.endswith(line + " \n ---------------------------"),
          "detector calibrate: the printed line is not the written one")
    vals = line.split(" = ", 1)[1].split(", ")
    mults = [float(v) for v in vals[:-1]]
    check(len(mults) == 23 and vals[-1] == "16", f"calibration line {line}")
    check(all(np.isfinite(m) and m > 0 for m in mults),
          f"calibration multipliers not finite and positive: {mults}")
    with open(VOC_CFG) as f:
        text = f.read()
    cal_cfg = os.path.join(tmp, "yolov2-voc-calibrated.cfg")
    with open(cal_cfg, "w") as f:
        f.write(text.replace("[net]\n", f"[net]\n{line}\n", 1))
    with contextlib.redirect_stderr(io.StringIO()):
        cspec = parse_network_cfg(cal_cfg, batch=1, quantized=True,
                                  echo_table=False)
    parsed = list(cspec.net.input_calibration)
    check(parsed == mults + [16.0],
          f"the port's cfg parses {parsed[:3]}... from the written line")

    spec, params, _ = detect.build_params(VOC_CFG, weights, echo=False)
    imgs = [im_io.resize_image(im_io.load_image(p, 3), 416, 416)
            for p in sorted(glob.glob(os.path.join(tmp, "calibds",
                                                   "*.png")))[:2]]
    t_first = []

    def timed_images():
        """The images, the clock started when the app asks for the first
        (after its forward is built and its weights are on the card)."""
        for img in imgs:
            if not t_first:
                torch.cuda.synchronize()
                t_first.append(time.perf_counter())
            yield img

    per_image = {}
    got = {}
    per_layer = {}
    for method in ("device", "host"):
        stdout = io.StringIO()
        with contextlib.redirect_stderr(io.StringIO()):
            with contextlib.redirect_stdout(io.StringIO()):
                calibrate.calibrate_multipliers(spec, params, iter(imgs[:1]),
                                                1, method)   # warm-up
            t_first.clear()
            with contextlib.redirect_stdout(stdout):
                got[method] = calibrate.calibrate_multipliers(
                    spec, params, timed_images(), len(imgs), method)
            per_image[method] = ((time.perf_counter() - t_first[0]) * 1e3
                                 / len(imgs))
        per_layer[method] = [float(v) for v in re.findall(
            r" multiplier = (\S+), l\.inputs", stdout.getvalue())]
    worst = max(abs(d - h) / h for d, h in zip(got["device"], got["host"]))
    check(worst <= 0.02, f"calibrate: device multipliers {got['device']} "
          f"not within 0.02 of host {got['host']} (worst {worst:.4f})")
    # each image's multiplier of each conv (its printed line): the device
    # sweep lands on the host's threshold bin m, or on a neighbour, where
    # multiplier = 127 / ((m + 0.5) / 16)
    check(len(per_layer["device"]) == len(per_layer["host"]) == 23 * 2,
          f"calibrate printed {len(per_layer['device'])} and "
          f"{len(per_layer['host'])} multiplier lines, not 46")
    bins = {m: [round(127 * 16 / v - 0.5) for v in per_layer[m]]
            for m in per_layer}
    bin_moves = [abs(d - h) for d, h in zip(bins["device"], bins["host"])]
    check(max(bin_moves) <= 1, f"calibrate: device threshold bins "
          f"{bins['device']} more than one bin from host {bins['host']}")
    say("old", f"detector calibrate -calib_method device over "
        f"{CALIB_IMAGES} images: 23 finite positive multipliers written "
        f"({mults[0]:g} ... {mults[-1]:g}, CLI {cli_s:.1f} s with its set-up), "
        f"parsed back by the port's cfg; over the first 2 images device and "
        f"host agree within {100 * worst:.3f}% (bound 2%), "
        f"{sum(m > 0 for m in bin_moves)} of 46 per-image multipliers one "
        f"threshold bin off the host's (bound 1 bin); ms per image after "
        f"set-up: device {per_image['device']:.1f}, "
        f"host {per_image['host']:.1f}")
    return {"multipliers": mults, "cli_s": cli_s, "ms_per_image": per_image,
            "worst_rel_diff_2_images": worst,
            "bins_moved_2_images": sum(m > 0 for m in bin_moves)}


def phase_old(tmp: str) -> dict:
    weights = os.path.join(tmp, "yolov2-voc.weights")
    save_random_weights(VOC_CFG, weights, seed=SEED)
    voc = [f"class_{i:02d}" for i in range(VOC_CLASSES)]
    voc_file = os.path.join(tmp, "voc20-old.names")
    with open(voc_file, "w") as f:
        f.write("\n".join(voc) + "\n")
    det = _old_detect(tmp, weights, voc_file, voc)
    piped = _old_pipeline(det.pop("spec"), det.pop("params"))
    return {"detect": det, "pipeline": piped,
            "calibrate": _old_calibrate(tmp, weights)}



# ---------------------------------------------------------------------------
# Phase 11: -bf16 on K6, detector demo, the softmax tree, -profile and -i
# ---------------------------------------------------------------------------


def _bf16_shapes() -> list:
    """yolov3-416's distinct conv shapes (H, W, C, M, ks, stride, pad), in
    the order of the net: every conv runs K6 under -bf16."""
    spec = parse_network_cfg(CFG, batch=1, echo_table=False)
    return list(dict.fromkeys((l.h, l.w, l.c, l.n, l.size, l.stride, l.pad)
                              for l in spec.conv_layers()))


def _bf16_label(shape) -> str:
    h, w, c, m, ks, s, _ = shape
    return f"{ks}x{ks}/s{s} {h}x{w}x{c}->{m}"


def check_bf16_sums(out, ref, x, wt, stride: int, pad: int,
                    what: str) -> tuple:
    """K6's ``out`` within ``bf16_conv.sum_bound`` of the plain twin's
    ``ref``: (largest difference, largest share of the bound)."""
    d = (out.double() - ref.double()).abs()
    lim = bf16_conv.sum_bound(x, wt, stride, pad)
    check(bool((d <= lim).all()),
          f"{what}: K6 off its plain twin beyond the float32-accumulate bound "
          f"(max {float(d.max()):.3g})")
    share = float((d / lim.clamp_min(1e-30)).max())
    return float(d.max()), share


def phase_bf16_kernels() -> list:
    """K6 against its plain twin at each of yolov3-416's 23 conv shapes (the
    first of them is also yolov2-voc-416's first conv), at b=1 and b=8:
    within the float32-accumulate bound, and every image of the b=8 result
    bit-identical to that image alone at b=1; with bias and leaky in its
    store (the main path's epilogue, BN folded into the weights) bit-equal
    to its bare conv followed by ``epilogue_plain``, the unfused chain. At
    b=1 (the main path's shapes) prints the plan (form, slab width, split of
    K across a cluster) and times K6 with its epilogue beside its bare
    conv, its bound (bytes: the float32 input read
    once, the bfloat16 weights, the bias, the float32 output written once;
    operations: the multiply-adds at the bf16 tensor-core peak), its plain
    twin with the epilogue, cuDNN's bfloat16 conv (the library call, never
    on the port's path; its sum is rounded to bfloat16) and cuDNN's float32
    conv of the bfloat16-rounded operands."""
    dev = torch.device("cuda")
    layers.set_fp32_precision()
    rows = []
    for i, (h, w, c, m, ks, s, pad) in enumerate(_bf16_shapes()):
        label = _bf16_label((h, w, c, m, ks, s, pad))
        rng = np.random.RandomState(SEED + i)
        x8 = torch.from_numpy(rng.randn(8, h, w, c).astype(np.float32)).to(dev)
        wt = torch.from_numpy((rng.randn(m, ks, ks, c) / np.sqrt(ks * ks * c))
                              .astype(np.float32)).to(dev).to(torch.bfloat16)
        bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
        x1 = x8[:1].contiguous()
        plan = bf16_conv.plan_launch(1, h, w, c, m, ks, s, pad)
        check(bf16_conv.plan_launch(8, h, w, c, m, ks, s, pad)._replace(
            tiles=0, blocks=0) == plan._replace(tiles=0, blocks=0),
            f"K6 {label}: the plan follows the batch")
        k32 = bf16_conv.pad_k32(wt) if plan.form == "c3" else None
        out8 = k6_bare(x8, wt, s, pad)
        ref8 = bf16_conv.conv2d_bf16_plain(x8, wt, s, pad)
        torch.cuda.synchronize()
        err, share = check_bf16_sums(out8, ref8, x8, wt, s, pad,
                                     f"{label} b=8")
        del ref8
        for j in range(8):
            one = k6_bare(x8[j:j + 1].contiguous(), wt, s, pad)
            check(torch.equal(out8[j:j + 1], one),
                  f"K6 {label}: image {j} of b=8 != that image at b=1")
        one = k6_bare(x1, wt, s, pad)
        e, sh = check_bf16_sums(one, bf16_conv.conv2d_bf16_plain(
            x1, wt, s, pad), x1, wt, s, pad, f"{label} b=1")
        err, share = max(err, e), max(share, sh)
        fused = bf16_conv.conv2d_bf16_cuda(x1, wt, s, pad, w_k32=k32,
                                           biases=bias, activation="leaky")
        check(torch.equal(fused, bf16_conv.epilogue_plain(one, bias,
                                                          "leaky")),
              f"K6 {label}: bias and leaky in the store != the unfused chain")
        del out8, x8
        xb = x1.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wt.permute(0, 3, 1, 2)
        xf, wf = xb.float(), wb.float()
        row = {"shape": label, "form": plan.form, "kc": plan.kc,
               "split": plan.split,
               "tile": [plan.tile_h, plan.tile_w], "stages": plan.stages,
               "blocks": plan.blocks, "max_abs_err": err,
               "bound_share_max": share, "epilogue_bit_equal": True}
        if c == 3:
            row["also"] = "yolov2-voc-416's first conv (the same shape)"
        row["ms"] = event_ms(lambda: bf16_conv.conv2d_bf16_cuda(
            x1, wt, s, pad, w_k32=k32, biases=bias, activation="leaky"))
        row["bare_ms"] = event_ms(lambda: bf16_conv.conv2d_bf16_cuda(
            x1, wt, s, pad, w_k32=k32))
        row["plain_ms"] = event_ms(lambda: bf16_conv.conv2d_bf16(
            x1, wt, s, pad, biases=bias, activation="leaky", plain=True),
            iters=20)
        row["library_ms"] = event_ms(lambda: torch.nn.functional.conv2d(
            xb, wb, stride=s, padding=pad))
        row["f32_conv_ms"] = event_ms(lambda: torch.nn.functional.conv2d(
            xf, wf, stride=s, padding=pad))
        oh, ow = (h + 2 * pad - ks) // s + 1, (w + 2 * pad - ks) // s + 1
        row["bound_ms"], row["bound_by"] = bound(
            4 * x1.numel() + 2 * wt.numel() + 4 * m + 4 * oh * ow * m,
            2.0 * oh * ow * m * ks * ks * c, PEAK_BF16_FLOPS)
        tile = ("flat" if plan.tile_h == 0
                else f"{plan.tile_h}x{plan.tile_w}")
        say("bf16", f"K6 {label}: within the float32-accumulate bound of the "
            f"plain twin at b=1 and b=8 (max |d| {err:.3g}, "
            f"{100 * share:.2f}% of the bound at most), every image of b=8 "
            f"bit-identical to it alone at b=1, bias and leaky in the store "
            f"bit-equal to the unfused chain; {plan.form} form, {tile}, "
            f"{plan.kc}-channel slabs, split {plan.split}, {plan.stages} "
            f"stages, {plan.blocks} blocks; K6 {row['ms']:.4f} ms (bare "
            f"{row['bare_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f}, cuDNN bf16 {row['library_ms']:.4f}, "
            f"cuDNN f32 of the bf16 operands {row['f32_conv_ms']:.4f} ms; "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
        rows.append(row)
    say("bf16", f"K6 over the 23 shapes: {sum(r['ms'] for r in rows):.4f} ms "
        f"(bare {sum(r['bare_ms'] for r in rows):.4f}), cuDNN bf16 "
        f"{sum(r['library_ms'] for r in rows):.4f}, bound "
        f"{sum(r['bound_ms'] for r in rows) * 1e3:.1f} us")
    return rows


def k6_profile(pred, x) -> dict:
    """One warm forward of ``pred`` under torch.profiler: K6's device time
    and launches, every kernel's device time (busy) and count, the ops of a
    leaky or an unfused BN (``aten::where``, ``gt``, ``mul``, ``sub``,
    ``div``) and the ``aten::add`` ops (a bias, or a shortcut) launched."""
    from torch.profiler import ProfilerActivity, profile
    pred(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the forward queued behind a device sleep (about 5 ms, left out of
        # the counts): some runs lost the first K6 kernels of the window
        # (59 of 75, 3 of 4) while the launch counters saw every launch
        torch.cuda._sleep(SLEEP_CYCLES // 5)
        pred(x)
        torch.cuda.synchronize()
    k6_us = busy_us = 0.0
    k6 = kernels = epilogue = adds = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "spin_kernel" in e.name:
                continue
            kernels += 1
            busy_us += e.self_device_time_total
            if "bf16_conv_kernel" in e.name:
                k6 += 1
                k6_us += e.self_device_time_total
        elif e.name in ("aten::where", "aten::gt", "aten::mul", "aten::sub",
                        "aten::div"):
            epilogue += 1
        elif e.name == "aten::add":
            adds += 1
    return {"k6_ms": k6_us / 1e3, "k6_launches": k6,
            "busy_ms": busy_us / 1e3, "device_ops": kernels,
            "epilogue_ops": epilogue, "add_ops": adds}


def _detection_lines_of(heads, i: int, pred, spec, w: int, h: int,
                        names) -> list:
    """``detect_image``'s printed lines of image ``i`` of a batch's heads."""
    outs = [hd.data[i].cpu().numpy() for hd in heads]
    dets = post_boxes.get_network_boxes(outs, pred.head_specs(), w, h,
                                        spec.net.w, spec.net.h,
                                        float(THRESH), relative=True)
    post_boxes.do_nms_sort(dets, pred.head_specs()[-1].classes, 0.4)
    return post_boxes.format_detections(dets, names, float(THRESH), w,
                                        h).splitlines()


def phase_bf16(tmp: str, weights: str, names_file: str, names: list) -> dict:
    """``detector test -bf16`` (and ``-quantized -bf16``) on yolov3-416
    through the CLI, the main path of K6: its launches in one forward (75;
    4 beside K1's 71), each of the forward's 75 convs within the
    float32-accumulate bound of the plain twin on the input the forward
    gives it, the heads near the plain path's (``check_bf16_heads``), and b=8:
    every image's heads bit-identical to its b=1 heads and its lines equal
    to its b=1 lines."""
    out = {}
    for flags, expect in ((["-bf16"], {"bf16_conv": 75}),
                          (["-quantized", "-bf16"],
                           {"int8_conv": 71, "bf16_conv": 4})):
        int8_conv.reset_launch_counts()
        bf16_conv.reset_plan_launches()
        rc, stdout, _ = run_cli(["detector", "test", names_file, CFG, weights,
                                 IMAGE, "-dont_show", "-thresh", THRESH,
                                 "-save", os.path.join(tmp, "pred_bf16")]
                                + flags)
        launches = {k: v for k, v in int8_conv.LAUNCH_COUNTS.items() if v}
        plans = dict(bf16_conv.PLAN_LAUNCHES)
        check(rc == 0, f"detector test {' '.join(flags)} exited {rc}")
        check(launches == expect, f"detector test {' '.join(flags)}: "
              f"launches {launches} in one forward, expected {expect}")
        check(plans.get("c3/kc32/split1") == 1,
              f"detector test {' '.join(flags)}: the first conv did not run "
              f"K6's c3 form ({plans})")
        lines = detection_text(stdout)
        if flags == ["-bf16"]:
            text = lines
        out[" ".join(flags)] = {"launches": launches, "plans": plans,
                                "detection_lines": len(lines.splitlines())}
        say("bf16", f"CLI {' '.join(flags)}: launches in one forward "
            f"{launches}, K6 by plan {plans}; {len(lines.splitlines())} "
            "detection lines")
    spec = parse_network_cfg(CFG, batch=1, echo_table=False)
    deep = [l for l in spec.conv_layers() if l.h in (13, 26)]
    check(all(bf16_conv.plan_launch(1, l.h, l.w, l.c, l.n, l.size, l.stride,
                                    l.pad).split > 1 for l in deep),
          "a -bf16 conv at 13x13 or 26x26 does not split K")
    say("bf16", f"-bf16 at b=1: each of the {len(deep)} convs whose input "
        "is 13x13 or 26x26 splits K across a cluster")

    spec, params, mode = detect.build_params(CFG, weights, echo=False)
    bf = dict(compute_dtype=torch.bfloat16)
    kernel = network.Predictor(spec, params, mode, device="cuda", **bf)
    plain = network.Predictor(spec, params, mode, device="cuda",
                              int8_impl="plain", **bf)
    # the forward's own conv inputs, each conv held to its bound
    fwd = network.build_forward(spec, mode, capture_conv_inputs=True, **bf)
    im = im_io.load_image(IMAGE, 3)
    x1 = im_io.resize_image(im, spec.net.w, spec.net.h)[None]
    lp = kernel.layer_params()
    with torch.inference_mode():
        _, aux = fwd(lp, torch.from_numpy(x1).cuda())
        convs = spec.conv_layers()
        check(len(aux["conv_inputs"]) == len(convs) == 75,
              "the -bf16 forward did not capture 75 conv inputs")
        worst = worst_share = 0.0
        for l, xin in zip(convs, aux["conv_inputs"]):
            wk = bf16_conv.kernel_weights(lp[l.index]["weights"])
            e, sh = check_bf16_sums(
                k6_bare(xin, wk, l.stride, l.pad),
                bf16_conv.conv2d_bf16_plain(xin, wk, l.stride, l.pad),
                xin, wk, l.stride, l.pad, f"-bf16 forward conv {l.index}")
            worst, worst_share = max(worst, e), max(worst_share, sh)
    del aux
    # K6 in one warm forward under the profiler, -bf16 and -quantized -bf16
    xt = torch.from_numpy(x1).cuda()
    prof = {"-bf16": k6_profile(kernel, xt)}
    spec8, params8, mode8 = detect.build_params(CFG, weights, quantized=True,
                                                echo=False)
    prof["-quantized -bf16"] = k6_profile(network.Predictor(
        spec8, params8, mode8, device="cuda", **bf), xt)
    del spec8, params8
    for flags, n in (("-bf16", 75), ("-quantized -bf16", 4)):
        p = prof[flags]
        check(p["k6_launches"] == n, f"{flags} forward under the profiler: "
              f"{p['k6_launches']} K6 kernels, expected {n}")
        say("bf16", f"{flags} forward (profiler, b=1): K6 {p['k6_ms']:.3f} ms "
            f"in {p['k6_launches']} launches; device busy {p['busy_ms']:.3f} "
            f"ms in {p['device_ops']} device operations; "
            f"{p['epilogue_ops']} leaky/BN ops (where, gt, mul, sub, div), "
            f"{p['add_ops']} aten::add")
    shortcuts = sum(isinstance(l, ShortcutSpec) for l in spec.layers)
    check(prof["-bf16"]["epilogue_ops"] == 0,
          "-bf16 forward: leaky or BN ran outside K6")
    check(prof["-bf16"]["add_ops"] == shortcuts,
          f"-bf16 forward: {prof['-bf16']['add_ops']} aten::add, expected "
          f"one at each of the {shortcuts} shortcuts (a bias ran outside K6)")
    out["profile"] = prof
    hk, hp = kernel(x1), plain(x1)
    check_heads(hk, "-bf16 kernel path")
    gap = check_bf16_heads([(a.data, b.data, a.index)
                            for a, b in zip(hk, hp)], "-bf16")
    head_err = gap["max"]
    say("bf16", f"-bf16 forward: each of its 75 convs within the "
        f"float32-accumulate bound of the plain twin on the input the "
        f"forward gives it (max |d| {worst:.3g}, {100 * worst_share:.2f}% of "
        f"the bound at most); heads against the plain path's: at least "
        f"{100 * gap['within_min']:.4f}% of each within rtol/atol "
        f"{bf16_conv.HEADS_TOL}, mean at most {gap['mean_max']:.3g}, max "
        f"{head_err:.3g}")

    # b=8: the dog and 7 random frames; each image's heads and lines at b=8
    # against the same image alone
    rng = np.random.RandomState(SEED)
    x8 = np.concatenate([x1] + [rng.rand(1, spec.net.h, spec.net.w, 3)
                                .astype(np.float32) for _ in range(7)])
    h8 = kernel(x8)
    n_lines = 0
    for i in range(8):
        h1 = hk if i == 0 else kernel(x8[i:i + 1])
        for a, b in zip(h8, h1):
            check(torch.equal(a.data[i:i + 1], b.data),
                  f"-bf16 head {a.index} of image {i}: b=8 != b=1")
        w, h = (im.shape[1], im.shape[0]) if i == 0 else (spec.net.w,
                                                          spec.net.h)
        l8 = _detection_lines_of(h8, i, kernel, spec, w, h, names)
        l1 = _detection_lines_of(h1, 0, kernel, spec, w, h, names)
        check(l8 == l1, f"-bf16 image {i}: b=8 lines != b=1 lines")
        if i == 0:
            check_same_lines("\n".join(l1), text,
                             "-bf16: lines of the b=1 forward and the CLI")
        n_lines += len(l1)
    ms = forward_ms(kernel, x1)
    say("bf16", f"-bf16 at b=8: every image's heads bit-identical to its b=1 "
        f"heads and its {n_lines} lines in all equal to its b=1 lines (F14 "
        f"repaired); warm b=1 forward {ms:.3f} ms (median, host clock, "
        "synchronised)")
    out.update(forward_convs_max_abs_err=worst,
               forward_convs_bound_share=worst_share,
               head_max_abs_err_vs_plain=head_err, heads_vs_plain=gap,
               b8_lines=n_lines,
               forward_ms=ms)
    return out


def _demo_frames_file(tmp: str) -> tuple:
    """A CVSTUBV1 raw video of DEMO_FRAMES 640x480 BGR frames from numpy
    (seed 10); returns (path, RGB frames)."""
    bgr = _frames(SEED + 3, DEMO_FRAMES)
    path = os.path.join(tmp, "demo.cvs")
    write_rawvideo(path, list(bgr), fps=25)
    return path, np.ascontiguousarray(bgr[..., ::-1])


def _demo_fps_file(tmp: str) -> str:
    """A CVSTUBV1 raw video of DEMO_FPS_FRAMES 640x480 BGR frames of uniform
    uint8 noise from numpy (seed 11); returns its path."""
    rng = np.random.RandomState(SEED + 4)
    frames = [rng.randint(0, 256, (FRAME_H, FRAME_W, 3), dtype=np.uint8)
              for _ in range(DEMO_FPS_FRAMES)]
    path = os.path.join(tmp, "demo_fps.cvs")
    write_rawvideo(path, frames, fps=25)
    return path


def _demo_fps(stdout: str) -> tuple:
    """Frames per second of a demo run from its own per-frame figures (each
    1 / the time since the previous frame): the frames after DEMO_WARM over
    the sum of their intervals, and the same over each quarter of them (the
    spread within the run; frames arrive in batches, so single figures
    swing)."""
    fps = [float(v) for v in re.findall(r"FPS:([0-9.]+)", stdout)][DEMO_WARM:]
    dt = [1.0 / max(f, 1e-3) for f in fps]
    q = len(dt) // 4
    return len(dt) / sum(dt), [q / sum(dt[i * q:(i + 1) * q])
                               for i in range(4)]


def _demo_blocks(stdout: str) -> list:
    """The object lines the demo printed for each frame."""
    blocks = stdout.split("\033[2J\033[1;1H\n")[1:]
    out = []
    for b in blocks:
        body = b.split("Objects:\n\n", 1)[1]
        out.append([l for l in body.splitlines()
                    if l and "CONVOLUTIONAL" not in l])
    return out


def phase_demo(tmp: str) -> dict:
    """``detector demo`` through the CLI on yolov3-416 (random weights, seed
    7, head biases made sparse as in phase 8, per mode, so that about
    DEMO_LIVE candidates of a frame pass the CLI's default thresh 0.25),
    with -dont_show, in the default bf16 mode (K6), in -fp32 and in
    -quantized. Over a 24-frame 640x480 raw video: no OpenCV imported,
    every frame processed, each frame's object lines those of the same
    pipeline on the same frames (as phase 8 compares them, F7). Over a
    256-frame one: the demo's frames per second (``_demo_fps``), printed
    with their spread over the run's quarters."""
    spec = parse_network_cfg(CFG, batch=1, echo_table=False)
    names = [f"class_{i:02d}" for i in range(N_CLASSES)]
    names_file = os.path.join(tmp, "demo.names")
    with open(names_file, "w") as f:
        f.write("\n".join(names) + "\n")
    video, rgb = _demo_frames_file(tmp)
    long_video = _demo_fps_file(tmp)
    check("cv2" not in sys.modules, "OpenCV was imported before the demo")
    rows = {}
    for mode, flags in (("bf16", []), ("fp32", ["-fp32"]),
                        ("int8", ["-quantized"])):
        cd = torch.float32 if mode == "fp32" else torch.bfloat16
        bias = calibrate_obj_bias(CFG, rgb[0], mode == "int8",
                                  {"compute_dtype": cd}, thresh=DEMO_THRESH,
                                  target=DEMO_LIVE)
        params = sparse_head_biases(spec, random_params(spec, seed=SEED),
                                    bias)
        weights = os.path.join(tmp, f"yolov3-demo-{mode}.weights")
        save_weights(spec, params, weights)
        int8_conv.reset_launch_counts()
        t0 = time.perf_counter()
        rc, stdout, err = run_cli(["detector", "demo", names_file, CFG,
                                   weights, video, "-dont_show"] + flags)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in int8_conv.LAUNCH_COUNTS.items() if v}
        check(rc == 0, f"detector demo {' '.join(flags)} exited {rc}")
        check("cv2" not in sys.modules,
              f"detector demo {' '.join(flags)} imported OpenCV")
        want_kernels = {"bf16": {"bf16_conv"}, "fp32": set(),
                        "int8": {"bf16_conv", "int8_conv"}}[mode]
        check(want_kernels <= set(launches),
              f"demo {mode}: launches {launches}, expected {want_kernels}")
        blocks = _demo_blocks(stdout)
        check(len(blocks) == DEMO_FRAMES,
              f"demo {mode}: {len(blocks)} frames of {DEMO_FRAMES}")

        # the same pipeline on the same frames, ingested as the demo does
        dspec, dparams, dmode = detect.build_params(
            CFG, weights, quantized=mode == "int8", echo=False)
        pipe = pipeline.DetectionPipeline(
            dspec, dparams, dmode, thresh=DEMO_THRESH,
            nms=0.2 if mode == "int8" else 0.4, k=256, compute_dtype=cd,
            device="cuda")
        sized = np.stack([im_io.resize_image(f.astype(np.float32) / 255.0,
                                             spec.net.w, spec.net.h)
                          for f in rgb])
        if mode == "bf16":
            sized = (sized * 255.0 + 0.5).astype(np.uint8)
        n_lines = n_near = 0
        for b0 in range(0, DEMO_FRAMES, 4):
            dets = pipe(sized[b0:b0 + 4], im_sizes=[(FRAME_W, FRAME_H)] * 4)
            for j, d in enumerate(dets):
                buf = io.StringIO()
                im_io.echo_detections_cv(d, names, DEMO_THRESH, N_CLASSES,
                                         FRAME_W, FRAME_H, buf)
                want = buf.getvalue().splitlines()
                near, _ = check_near_lines(
                    blocks[b0 + j], want,
                    f"demo {mode}: frame {b0 + j} against the pipeline")
                n_lines, n_near = n_lines + len(want), n_near + near
        check(n_lines > 0, f"demo {mode}: no object line")
        rc, stdout, _ = run_cli(["detector", "demo", names_file, CFG,
                                 weights, long_video, "-dont_show"] + flags)
        check(rc == 0, f"detector demo {' '.join(flags)} on the "
              f"{DEMO_FPS_FRAMES}-frame video exited {rc}")
        n_long = len(_demo_blocks(stdout))
        check(n_long == DEMO_FPS_FRAMES,
              f"demo {mode}: {n_long} frames of {DEMO_FPS_FRAMES}")
        check("cv2" not in sys.modules,
              f"detector demo {' '.join(flags)} imported OpenCV")
        steady, quarters = _demo_fps(stdout)
        rows[mode] = {"frames": len(blocks), "obj_bias": bias,
                      "object_lines": n_lines,
                      "lines_off_by_a_count": n_near, "fps": steady,
                      "fps_quarters": quarters, "fps_frames": n_long,
                      "wall_s": wall, "launches_at_capture": launches}
        say("demo", f"detector demo {' '.join(flags) or '(bf16)'}: "
            f"{len(blocks)} of {DEMO_FRAMES} frames, no OpenCV imported; "
            f"{n_lines} object lines equal to the pipeline's on the same "
            f"frames ({n_near} with a box field one count off); "
            f"{wall:.2f} s with set-up and capture; kernels captured "
            f"{launches}; over {n_long} frames {steady:.1f} frames per "
            f"second after frame {DEMO_WARM} (quarters "
            + " / ".join(f"{q:.1f}" for q in quarters) + ")")
        del pipe
    return rows


def phase_tree(tmp: str) -> dict:
    """The mini YOLO9000 net (tests/test_tree.py's tree and cfg, random
    weights from seed 31) on the card: ``detector test -quantized`` through
    the CLI (K1 at its int8 convs) with heads and lines equal to the plain
    path's; the pipeline (device decode of the tree head, device NMS) with
    its detections equal to ``detect_image``'s (phase 8's comparison) and
    to the plain pipeline's."""
    tree = os.path.join(tmp, "mini.tree")
    with open(tree, "w") as f:
        f.write(TREE_TEXT)
    cfg = os.path.join(tmp, "mini-tree.cfg")
    with open(cfg, "w") as f:
        f.write(TREE_CFG.format(tree_path=tree))
    weights = os.path.join(tmp, "mini-tree.weights")
    save_random_weights(cfg, weights, seed=31)
    names_file = os.path.join(tmp, "tree.names")
    with open(names_file, "w") as f:
        f.write("\n".join(TREE_NAMES) + "\n")
    int8_conv.reset_launch_counts()
    rc, stdout, _ = run_cli(["detector", "test", names_file, cfg, weights,
                             IMAGE, "-dont_show", "-thresh", "0.2",
                             "-quantized", "-save",
                             os.path.join(tmp, "pred_tree")])
    check(rc == 0, f"detector test on the tree net exited {rc}")
    launches = {k: v for k, v in int8_conv.LAUNCH_COUNTS.items() if v}
    check(launches.get("int8_conv", 0) > 0, "tree net: K1 not launched")
    text = detection_text(stdout)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        plain_text = detect.run(TREE_NAMES, cfg, weights, IMAGE, thresh=0.2,
                                quantized=True, int8_impl="plain",
                                save_path=os.path.join(tmp, "pred_tree_p"),
                                device="cuda")
    check_same_lines(text, plain_text.rstrip("\n"),
                     "tree net: lines of the kernel and the plain path")
    spec, params, mode = detect.build_params(cfg, weights, quantized=True,
                                             echo=False)
    check(spec.layers[-1].softmax_tree is not None, "tree net: no tree")
    kernel = network.Predictor(spec, params, mode, device="cuda")
    plain = network.Predictor(spec, params, mode, device="cuda",
                              int8_impl="plain")
    x = np.random.RandomState(SEED).rand(2, 64, 64, 3).astype(np.float32)
    for a, b in zip(kernel(x), plain(x)):
        check(torch.equal(a.data, b.data), "tree net: heads of the kernel "
              "and the plain path differ")
    args = dict(thresh=0.2, nms=0.4, k=256, device_nms=True, device="cuda")
    piped = pipeline.DetectionPipeline(spec, params, mode, **args)
    # the plain twins make host scalars on the fly, which a CUDA graph
    # cannot capture: the plain pipeline runs eagerly
    piped_plain = pipeline.DetectionPipeline(spec, params, mode,
                                             int8_impl="plain",
                                             cuda_graph=False, **args)
    frames = (np.random.RandomState(SEED).rand(4, 64, 64, 3) * 255).astype(
        np.uint8)
    from PIL import Image
    n_lines = 0
    for i, (d, dp) in enumerate(zip(piped(frames), piped_plain(frames))):
        got = post_boxes.format_detections(d, TREE_NAMES, 0.2, 64,
                                           64).splitlines()
        check(got == post_boxes.format_detections(
            dp, TREE_NAMES, 0.2, 64, 64).splitlines(),
            f"tree net: pipeline lines of frame {i} != the plain pipeline's")
        path = os.path.join(tmp, f"tree_frame{i}.png")
        Image.fromarray(frames[i]).save(path)
        host, _, _ = detect.detect_image(kernel, spec, path, 0.2, 0.4,
                                         TREE_NAMES)
        check_near_lines(got, post_boxes.format_detections(
            host, TREE_NAMES, 0.2, 64, 64).splitlines(),
            f"tree net: pipeline and detect_image lines of frame {i}")
        n_lines += len(got)
    check(n_lines > 0, "tree net: no pipeline detection")
    say("tree", f"mini YOLO9000 tree net: detector test -quantized launches "
        f"{launches}; {len(text.splitlines())} lines and the heads equal "
        f"the plain path's; the pipeline's {n_lines} lines over 4 frames "
        "equal the plain pipeline's and detect_image's")
    return {"launches": launches, "lines": len(text.splitlines()),
            "pipeline_lines": n_lines}


def phase_profile(tmp: str, weights: str, names_file: str) -> dict:
    """``detector test -bf16 -profile DIR`` writes a torch.profiler trace
    with device activity; ``profile_layers`` times the -bf16 forward layer
    by layer with CUDA events (the ten costliest layers printed);
    ``-i 0`` prints the lines it prints without it."""
    prof = os.path.join(tmp, "profile")
    base = ["detector", "test", names_file, CFG, weights, IMAGE, "-dont_show",
            "-thresh", THRESH, "-bf16", "-save",
            os.path.join(tmp, "pred_prof")]
    rc, out_p, _ = run_cli(base + ["-profile", prof])
    check(rc == 0, f"detector test -profile exited {rc}")
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    k6_events = sum("bf16_conv_kernel" in str(e.get("name", ""))
                    for e in events)
    check(k6_events >= 75, f"-profile trace: {k6_events} K6 events")
    rc, out_i, _ = run_cli(base + ["-i", "0"])
    check(rc == 0, "detector test -i 0 failed")
    check_same_lines(detection_text(out_i), detection_text(out_p),
                     "-i 0 and the run without it")
    spec, params, _ = detect.build_params(CFG, weights, echo=False)
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    rows = profiling.profile_layers(spec, params, x, iters=3,
                                    compute_dtype=torch.bfloat16,
                                    device="cuda")
    check(len(rows) == spec.n and all(r[3] >= 0 for r in rows),
          "profile_layers rows")
    top = sorted(rows, key=lambda r: -r[3])[:10]
    size = os.path.getsize(os.path.join(prof, "trace.json"))
    say("profile", f"-profile wrote {size} bytes of trace with {k6_events} "
        f"K6 kernel events; -i 0 prints the "
        f"same lines; -bf16 forward layer by layer (CUDA events): "
        f"{rows[-1][2]:.3f} ms to layer {rows[-1][0]}, costliest "
        + ", ".join(f"{r[0]} {r[1]} {r[3]:.3f}" for r in top))
    return {"trace_k6_events": k6_events, "total_ms": rows[-1][2],
            "top_layers": [list(r) for r in top]}

# ---------------------------------------------------------------------------
# phase 12: the multi-device axes on one card
# ---------------------------------------------------------------------------

PAR_B = 2                # images a sharded forward
PAR_RUNS = 50            # wavefront runs of the cross-stream check
PAR_NOTE = ("one card, n positions: every position a stream of cuda:0, so "
            "a wall shows the cost of the extra launches and copies, not "
            "scaling")
# an fp32 forward under model or space against the single-device one (the
# float convs of a channel slice or a row slab may run other cuDNN
# algorithms, which sum in another order): tests/test_torch_network.py's
# float tolerance
PAR_FLOAT = dict(rtol=1e-4, atol=1e-5)


def _cards(n: int) -> list:
    return [torch.device("cuda", 0)] * n


def _synced(fn):
    def call():
        out = fn()
        torch.cuda.synchronize()
        return out
    return call


def _gap(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def _same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _counts() -> dict:
    return {k: v for k, v in int8_conv.LAUNCH_COUNTS.items() if v}


def _fused_expect(spec, stages, microbatches: int) -> dict:
    """K2 and K1 launches of a staged fused forward: per stage (its runs
    between collectives, its positions), the residual blocks whose run lies
    inside one of its runs launch K2, the other int8 convs K1."""
    int8_set = network._int8_layer_set(spec, "cpu")
    runs = network._fused_stage_runs(spec, int8_set)
    k1 = k2 = 0
    for ranges, positions in stages:
        lo, hi = ranges[0][0], ranges[-1][1]
        blocks = sum(len(r) for st, r in runs.items()
                     if any(st >= a and r[-1][2] < b for a, b in ranges))
        convs = sum(lo <= i < hi for i in int8_set)
        k2 += positions * blocks
        k1 += positions * (convs - 2 * blocks)
    return {"fused_res_block": k2 * microbatches,
            "int8_conv": k1 * microbatches}


def _pp_stages(pp) -> list:
    """(runs, positions) of each stage of a PipelinedPredictor."""
    if pp.tp == 1:
        return [([r], 1) for r in pp.ranges]
    return [([(s.a, s.b) for s in fn.segments], fn.mesh.size)
            for fn in pp.stage_fns]


def _par_row(name: str, positions: int, got, want, single_wall: float,
             call, expect: dict, exact: bool, tol=None) -> dict:
    """Check one sharded or staged forward against the single-device one
    and its launches against the rule; time both."""
    launches = _counts()
    for k, v in expect.items():
        check(launches.get(k, 0) == v,
              f"parallel {name}: {k} launched {launches.get(k, 0)} times, "
              f"the rule gives {v}")
    gap = _gap(got, want)
    same = _same(got, want)
    if exact:
        check(same, f"parallel {name}: heads differ from the single-device "
              f"forward's (max {gap:.3g})")
    elif tol is not None:
        for g, w in zip(got, want):
            check(bool(torch.allclose(g, w, **tol)),
                  f"parallel {name}: heads beyond rtol {tol['rtol']} atol "
                  f"{tol['atol']} of the single-device forward's "
                  f"(max {gap:.3g})")
    wall = wall_ms(call, iters=10)
    row = {"config": name, "positions": positions, "launches": launches,
           "rule": expect, "bit_identical": same, "max_abs_gap": gap,
           "wall_ms": wall, "single_wall_ms": single_wall}
    say("parallel", f"{name}: {positions} positions; heads "
        + ("bit-identical to" if same else f"within {gap:.3g} of")
        + " the single-device forward's; "
        + ("launches " + ", ".join(f"{k} {v}"
                                   for k, v in sorted(launches.items()))
           + " (the rule's)" if launches else "no hand kernel (cuDNN)")
        + f"; wall {wall:.3f} ms against {single_wall:.3f} ms on one "
        "position")
    return row


def _sharded(name, spec, params, mode, axes, x, want, single_wall, expect,
             exact, tol=None, **kw) -> dict:
    n = int(np.prod(list(axes.values())))
    mesh = par_mesh.make_mesh(n, **axes, devices=_cards(n))
    fn, sh = par_mesh.make_sharded_predict(spec, params, mesh, mode, **kw)
    for l in spec.conv_layers():
        if l.index in par_mesh.sharded_layers(spec, mesh):
            for pos, p in zip(mesh.positions, sh):
                for v in p[l.index].values():
                    if isinstance(v, torch.Tensor) and v.dim() > 1:
                        check(v.shape[0] == l.n // axes["model"],
                              f"parallel {name}: conv {l.index} holds "
                              f"{v.shape[0]} of {l.n} rows at {pos.index}")
    fn(sh, x)                                     # warm (cuDNN's choice)
    torch.cuda.synchronize()
    int8_conv.reset_launch_counts()
    got = fn(sh, x)
    torch.cuda.synchronize()
    expect = {k: v * mesh.size for k, v in expect.items()}
    return _par_row(name, mesh.size, got, want, single_wall,
                    _synced(lambda: fn(sh, x)), expect, exact, tol), got


def _single(spec, params, mode, x, **kw):
    pred = network.Predictor(spec, params, mode, device="cuda", **kw)
    heads = [h.data for h in pred(x)]
    torch.cuda.synchronize()
    return heads, wall_ms(_synced(lambda: pred(x)), iters=10), pred


def _per_image(pred, x) -> list:
    outs = [pred(x[i:i + 1]) for i in range(x.shape[0])]
    return [torch.cat([o[h].data for o in outs]) for h in range(len(outs[0]))]


def _bf16_slab_sums(spec, mesh) -> dict:
    """K6 against its plain twin within ``bf16_conv.sum_bound`` at every
    conv shape a space-split -bf16 forward of ``spec`` gives it (the slabs'
    rows, with their halo rows)."""
    fwd = par_mesh.ShardedForward(spec, mesh, "fp32",
                                  compute_dtype=torch.bfloat16)
    halo = {s.a: s.halo for s in fwd.segments if s.halo is not None}
    shapes = set()
    for l in spec.conv_layers():
        for s in range(mesh.shape["space"]):
            if l.index in halo:
                e0, e1 = halo[l.index][s][0]
                rows = e1 - e0
            else:
                r0, r1 = fwd.slab(l.h, s)
                rows = r1 - r0
            shapes.add((rows, l.w, l.c, l.n, l.size, l.stride, l.pad))
    dev = torch.device("cuda")
    worst = 0.0
    for i, (h, w, c, m, ks, s, pad) in enumerate(sorted(shapes)):
        rng = np.random.RandomState(SEED + 1000 + i)
        x = torch.from_numpy(rng.randn(1, h, w, c).astype(np.float32)).to(dev)
        wt = torch.from_numpy((rng.randn(m, ks, ks, c) / np.sqrt(ks * ks * c))
                              .astype(np.float32)).to(dev).to(torch.bfloat16)
        out = k6_bare(x, wt, s, pad)
        ref = bf16_conv.conv2d_bf16_plain(x, wt, s, pad)
        torch.cuda.synchronize()
        _, share = check_bf16_sums(out, ref, x, wt, s, pad,
                                   f"sp2 slab {ks}x{ks}/s{s} {h}x{w}x{c}->{m}")
        worst = max(worst, share)
    return {"shapes": len(shapes), "largest_share_of_bound": worst}


def phase_parallel(tmp: str, weights: str, names_file: str, names: list,
                   smi_line: str) -> dict:
    """Phase 12: the multi-device axes (``parallel/mesh.py``,
    ``parallel/pp.py``) on the one card, every position a stream of
    cuda:0."""
    out = {"card": smi_line, "note": PAR_NOTE, "configs": []}
    rows = out["configs"]
    rng = np.random.RandomState(SEED + 12)
    x = rng.rand(PAR_B, 416, 416, 3).astype(np.float32)

    # int8 xla: every axis bit-identical, K1 once per position and int8 conv
    spec, params, mode = detect.build_params(CFG, weights, quantized=True,
                                             echo=False)
    int8_set = network._int8_layer_set(spec, "cpu")
    want, wall1, pred = _single(spec, params, mode, x)
    for axes in (dict(data=2), dict(model=2), dict(space=2),
                 dict(data=2, space=2, model=2)):
        name = "int8 " + " x ".join(f"{a}{v}" for a, v in axes.items())
        rows.append(_sharded(name, spec, params, mode, axes, x, want, wall1,
                             {"int8_conv": len(int8_set)}, exact=True)[0])
    # -turbo_int8: the int8 trunk's tensors cross the collectives beside
    # their float views (K1's int8 store on a sliced M and on row slabs)
    twant, twall, _ = _single(spec, params, mode, x, turbo="int8")
    rows.append(_sharded("int8 turbo_int8 space2 x model2", spec, params,
                         mode, dict(space=2, model=2), x, twant, twall,
                         {"int8_conv": len(int8_set)}, exact=True,
                         turbo="int8")[0])

    # int8 fused: stages (K2 within a stage, K1 where a run straddles)
    fused = network.Predictor(spec, params, mode, device="cuda",
                              int8_impl="fused")
    want_mb = _per_image(fused, x)
    wall_f = wall_ms(_synced(lambda: _per_image(fused, x)), iters=10)
    for name, make in (
            ("int8 fused pp2", lambda: par_pp.PipelinedPredictor(
                spec, params, mode, n_stages=2, microbatch=1,
                int8_impl="fused", devices=_cards(2))),
            ("int8 fused pp2 x tp2", lambda: par_pp.PipelinedPredictor(
                spec, params, mode, n_stages=2, microbatch=1, tp=2,
                int8_impl="fused", devices=_cards(4))),
            ("int8 fused 2 replicas x pp2", lambda: par_pp.ReplicatedPipeline(
                spec, params, mode, replicas=2, n_stages=2, microbatch=1,
                int8_impl="fused", devices=_cards(4)))):
        pp = make()
        reps = getattr(pp, "replicas", [pp])
        expect = collections.Counter()
        for rep in reps:
            expect.update(_fused_expect(spec, _pp_stages(rep),
                                        PAR_B // len(reps)))
        pp(x)
        torch.cuda.synchronize()
        int8_conv.reset_launch_counts()
        got = [h.data for h in pp(x)[0]]
        torch.cuda.synchronize()
        rows.append(_par_row(name, sum(len(r.devices) for r in reps), got,
                             want_mb, wall_f,
                             _synced(lambda: pp(x)), dict(expect),
                             exact=True))
        rows[-1]["ranges"] = reps[0].ranges
        del pp, reps
    del fused, pred

    # XNOR under tp2: K3 and K4 on sliced weights
    xspec, xparams, xmode = detect.build_params(XNOR_CFG, None, seed=SEED,
                                                echo=False)
    bit = sum(1 for l in xspec.conv_layers()
              if l.xnor and network._bit_path(l))
    for impl, kernel in (("pallas_mxu", "xnor_gemm_mxu"),
                         ("pallas", "xnor_gemm")):
        xwant, xwall, _ = _single(xspec, xparams, xmode, x, xnor_impl=impl)
        rows.append(_sharded(f"tiny-yolo-obj_xnor {impl} model2", xspec,
                             xparams, xmode, dict(model=2), x, xwant, xwall,
                             {kernel: bit}, exact=True,
                             xnor_impl=impl)[0])

    # -bf16: data bit-identical (K6 is batch-invariant), space within the
    # bf16 limits of phase 8-11
    fspec, fparams, fmode = detect.build_params(CFG, weights, echo=False)
    bwant, bwall, _ = _single(fspec, fparams, fmode, x,
                              compute_dtype=torch.bfloat16)
    n_float = len(fspec.conv_layers())
    rows.append(_sharded("bf16 data2", fspec, fparams, fmode, dict(data=2),
                         x, bwant, bwall, {"bf16_conv": n_float}, exact=True,
                         compute_dtype=torch.bfloat16)[0])
    row, got = _sharded("bf16 space2", fspec, fparams, fmode, dict(space=2),
                        x, bwant, bwall, {"bf16_conv": n_float}, exact=False,
                        compute_dtype=torch.bfloat16)
    mesh = par_mesh.make_mesh(2, space=2, devices=_cards(2))
    row["heads_gap"] = check_bf16_heads(
        [(g, w, i) for g, w, i in zip(got, bwant, (82, 94, 106))],
        "bf16 space2 against one position")
    row["slab_sums"] = _bf16_slab_sums(fspec, mesh)
    say("parallel", f"bf16 space2: heads within the bf16 limits "
        f"({row['heads_gap']}); K6 within its float32-accumulate bound at "
        f"the {row['slab_sums']['shapes']} slab shapes (largest share "
        f"{row['slab_sums']['largest_share_of_bound']:.3g})")
    rows.append(row)

    # fp32 under model and space: within PAR_FLOAT
    fwant, fwall, _ = _single(fspec, fparams, fmode, x)
    for axes in (dict(model=2), dict(space=2)):
        name = "fp32 " + " x ".join(f"{a}{v}" for a, v in axes.items())
        rows.append(_sharded(name, fspec, fparams, fmode, axes, x, fwant,
                             fwall, {}, exact=False, tol=PAR_FLOAT)[0])
    del fparams, bwant, fwant

    out["pipeline"] = _par_pipeline(tmp, names)
    out["wavefront"] = _par_wavefront(spec, params, mode)
    out["commvol"] = _par_commvol(spec, params, mode, weights, smi_line)

    # the CLI on one card: -pp 2 needs two GPUs
    rc, stdout, err = run_cli(["detector", "test", names_file, CFG, weights,
                               IMAGE, "-pp", "2", "-dont_show", "-save",
                               os.path.join(tmp, "pred_pp")])
    check(rc == 1 and "need 2 devices, have 1" in err
          and "Predicted in" not in stdout,
          f"detector test -pp 2 on one card exited {rc}: {err[-300:]!r}")
    out["cli_pp2_one_card"] = err.strip().splitlines()[-1]
    say("parallel", f"detector test -pp 2 on one card exits 1: "
        f"{out['cli_pp2_one_card']}")
    return out


def _par_pipeline(tmp: str, names: list) -> dict:
    """DetectionPipeline with device NMS on 640x480 uint8 frames at b=2,
    under data2 x model2 and under pp2: the detections of the
    single-device pipeline (frame by frame), K7 and the walk once a batch on
    the gathered heads."""
    frames = _frames(SEED + 12, PAR_B)
    bias = calibrate_obj_bias(CFG, frames[0], True, {"int8_impl": "xla"})
    spec, params, mode = detect.build_params(CFG, None, quantized=True,
                                             seed=SEED, echo=False)
    sparse_head_biases(spec, params, bias)
    args = dict(thresh=PIPE_THRESH, nms=PIPE_NMS, k=PIPE_K, device_nms=True)
    single = pipeline.DetectionPipeline(spec, params, mode, device="cuda",
                                        **args)
    want = [single(frames[i:i + 1])[0] for i in range(PAR_B)]
    wall1 = wall_ms(lambda: single(frames), iters=10)
    res = {"obj_bias": bias}
    for name, kw in (
            ("data2 x model2", dict(mesh=par_mesh.make_mesh(
                4, data=2, model=2, devices=_cards(4)))),
            ("pp2", dict(pp_stages=2, pp_microbatch=1,
                         pp_devices=_cards(2)))):
        pipe = pipeline.DetectionPipeline(spec, params, mode, device="cuda",
                                          **args, **kw)
        check(not pipe._cuda_graph, f"pipeline {name}: captured")
        pipe(frames)
        int8_conv.reset_launch_counts()
        got = pipe(frames)
        launches = _counts()
        for k in ("nms_order", "nms_walk"):
            check(launches.get(k) == 1,
                  f"pipeline {name}: {k} launched {launches.get(k)} times "
                  "for one batch")
        n_lines = n_near = 0
        for i in range(PAR_B):
            w = _lines(want[i], names, FRAME_W, FRAME_H)
            near, _ = check_near_lines(_lines(got[i], names, FRAME_W,
                                              FRAME_H), w,
                                       f"pipeline {name} frame {i}")
            n_lines, n_near = n_lines + len(w), n_near + near
        check(n_lines > 0, f"pipeline {name}: no detection line")
        wall = wall_ms(lambda: pipe(frames), iters=10)
        res[name] = {"launches": launches, "detection_lines": n_lines,
                     "lines_off_by_a_count": n_near, "wall_ms": wall,
                     "single_wall_ms": wall1}
        say("parallel", f"pipeline {name}: {n_lines} detection lines of "
            f"{PAR_B} 640x480 frames equal the single-device pipeline's "
            f"({n_near} a count off); nms_order and nms_walk once a batch; "
            f"launches {launches}; wall {wall:.3f} ms against {wall1:.3f} ms "
            "(captured, one position)")
    return res


def _par_wavefront(spec, params, mode) -> dict:
    """The pp2 wavefront (two stages on two streams of the card, b=4 in
    microbatches of 1) run PAR_RUNS times with no synchronisation between
    runs, every run's heads kept and then compared with the first's and
    with the single-device forward's: the caching allocator must not hand a
    block that one stream still reads to the other."""
    x = np.random.RandomState(SEED + 13).rand(4, 416, 416, 3).astype(
        np.float32)
    pp = par_pp.PipelinedPredictor(spec, params, mode, n_stages=2,
                                   microbatch=1, devices=_cards(2))
    pred = network.Predictor(spec, params, mode, device="cuda")
    want = _per_image(pred, x)
    xs = torch.from_numpy(x).cuda()
    t0 = time.perf_counter()
    runs = [[h.data for h in pp(xs)[0]] for _ in range(PAR_RUNS)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / PAR_RUNS
    for r, got in enumerate(runs):
        check(_same(got, want), f"wavefront run {r}: heads differ from the "
              "single-device forward's")
    say("parallel", f"pp2 wavefront: {PAR_RUNS} unsynchronised runs at b=4, "
        f"every run's heads bit-identical to the single-device forward's; "
        f"{wall:.3f} ms a run")
    return {"runs": PAR_RUNS, "all_bit_identical": True, "ms_a_run": wall}


# the meshes whose communication phase 12 records (int8 xla, b=PAR_B) and
# the stage counts of its fused pipelines
COMM_MESHES = [dict(data=2), dict(model=2), dict(space=2), dict(model=4),
               dict(model=8), dict(space=4), dict(space=8),
               dict(data=2, space=2, model=2)]
# -turbo_int8's int8 trunk tensors cross beside the float32 ones, at 1 byte
COMM_TURBO = dict(space=2, model=2)
COMM_STAGES = (2, 4)
COMM_ANCHOR_B = 8        # images a forward of the compute anchors
COMM_LABELS = {"data": "dp", "space": "sp", "model": "tp"}


def _comm_label(axes: dict) -> str:
    """tp, sp or dp for one axis (the JAX table's rows), else each axis with
    its size."""
    if len(axes) == 1:
        return COMM_LABELS[next(iter(axes))]
    return " x ".join(f"{COMM_LABELS[a]}{v}" for a, v in axes.items())


def _all_counts() -> tuple:
    return (dict(int8_conv.LAUNCH_COUNTS), dict(int8_conv.FORM_LAUNCHES),
            dict(int8_conv.PRE_LAUNCHES), dict(bf16_conv.PLAN_LAUNCHES))


def _off_and_on(name: str, call) -> tuple:
    """``call()`` with the recorder off and on (after a warm call): the
    heads and every launch count must be the same; returns (log,
    launches)."""
    call()
    torch.cuda.synchronize()
    runs = []
    for on in (False, True):
        int8_conv.reset_launch_counts()
        bf16_conv.reset_plan_launches()
        with (commvol.recording() if on else contextlib.nullcontext()) as log:
            heads = call()
        torch.cuda.synchronize()
        runs.append((heads, log, _all_counts()))
    (off, _, c_off), (on, log, c_on) = runs
    check(c_on == c_off, f"commvol {name}: launches with the recorder on "
          f"{c_on[0]} differ from those with it off {c_off[0]}")
    check(_same(on, off), f"commvol {name}: heads with the recorder on "
          "differ from those with it off")
    check(commvol.current() is None, f"commvol {name}: recorder left on")
    return log, c_on[0]


def anchor_ms(spec, params, mode: str, **kw) -> float:
    """One position's compute anchor: the card's ms per image of a
    ``network.Predictor`` forward (``kw``: its keywords) at
    ``COMM_ANCHOR_B`` images, input on the card, 10 forwards queued behind
    a device sleep twice as long as the host takes to issue them."""
    iters = 10
    pred = network.Predictor(spec, params, mode, device="cuda", **kw)
    x = torch.from_numpy(np.random.RandomState(SEED).rand(
        COMM_ANCHOR_B, spec.net.h, spec.net.w, spec.net.c).astype(
            np.float32)).cuda()
    with torch.inference_mode():
        pred(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred(x)
        torch.cuda.synchronize()
        cycles = int(max(SLEEP_CYCLES,
                         2 * iters * (time.perf_counter() - t0) * 2.0e9))
        return event_ms(lambda: pred(x), iters=iters, warmup=1,
                        sleep_cycles=cycles) / COMM_ANCHOR_B


def _par_commvol(spec, params, mode, weights: str, smi_line: str) -> dict:
    """The communication account (``parallel/commvol.py``): the recorder's
    entries of yolov3-416 int8 xla under ``COMM_MESHES``, of its
    ``-turbo_int8`` under ``COMM_TURBO`` (the int8 trunk at 1 byte an
    element) and of the fused pipelines of ``COMM_STAGES`` equal the count
    from layer shapes (``tests/commvol_count.py``); heads and
    launches the same with it on and off; the compute anchors (one
    position's device ms per image at b=8) and the projection on NVIDIA's
    published NVLink figure."""
    x = np.random.RandomState(SEED + 15).rand(
        PAR_B, spec.net.h, spec.net.w, spec.net.c).astype(np.float32)
    res = {"meshes": [], "pp": []}
    wire = {}
    twins = commvol_count.int8_twins(spec)
    for axes, kw in ([(a, {}) for a in COMM_MESHES]
                     + [(COMM_TURBO, dict(turbo="int8"))]):
        name = _comm_label(axes)
        n = int(np.prod(list(axes.values())))
        config = name if len(axes) > 1 else f"{name}{n}"
        if kw:
            config = f"turbo_int8 {config}"
        mesh = par_mesh.make_mesh(n, **axes, devices=_cards(n))
        fn, sh = par_mesh.make_sharded_predict(spec, params, mesh, mode, **kw)
        log, launches = _off_and_on(config, lambda: fn(sh, x))
        got = commvol_count.recorded(log)
        want = commvol_count.expected_mesh(spec, axes, PAR_B,
                                           twins=twins if kw else ())
        check(got == want, f"commvol {config}: recorded "
              f"{sorted(got.items())[:6]} ... differ from the count from "
              f"layer shapes {sorted(want.items())[:6]} ...")
        if kw:
            check(got != commvol_count.expected_mesh(spec, axes, PAR_B),
                  f"commvol {config}: no int8 tensor crossed")
        vols, per_img = commvol.mesh_volumes(log, mesh, PAR_B)
        pace = commvol.pacing_position(log, mesh.size)
        by_what = collections.Counter()
        for e in log.entries:
            if e.position == pace:
                by_what[e.what] += e.nbytes
        if not kw:
            wire[(name, n)] = per_img
        res["meshes"].append({
            "config": config, "positions": n, "launches": launches,
            "entries": len(log.entries), "pacing_position": list(pace),
            "wire_bytes_img": per_img,
            "pacing_bytes_by_kind": dict(by_what), "volumes": vols})
        images = PAR_B // axes.get("data", 1)
        say("commvol", f"int8 {config}: "
            f"{len(log.entries)} entries = the count from layer shapes; heads "
            f"and launches ({launches}) the same with the recorder on and "
            f"off; pacing position {pace}: {per_img / 1e6:.3f} MB of wire a "
            "image (" + ", ".join(f"{k} {v / images / 1e6:.3f} MB"
                                  for k, v in sorted(by_what.items())) + ")")
        del fn, sh
    # -bf16 under space2 moves the bytes int8 xla does (float32 crosses)
    fspec, fparams, fmode = detect.build_params(CFG, weights, echo=False)
    mesh = par_mesh.make_mesh(2, space=2, devices=_cards(2))
    fn, sh = par_mesh.make_sharded_predict(fspec, fparams, mesh, fmode,
                                           compute_dtype=torch.bfloat16)
    log, _ = _off_and_on("bf16 sp2", lambda: fn(sh, x))
    check(commvol.mesh_volumes(log, mesh, PAR_B)[1] == wire[("sp", 2)],
          "commvol bf16 sp2: wire bytes differ from int8 sp2's")
    del fn, sh
    # the fused pipelines: each boundary's live set once a microbatch
    pp_bytes = {}
    for n in COMM_STAGES:
        pp = par_pp.PipelinedPredictor(spec, params, mode, n_stages=n,
                                       microbatch=1, int8_impl="fused",
                                       devices=_cards(n))
        log, launches = _off_and_on(
            f"fused pp{n}", lambda: [h.data for h in pp(x)[0]])
        bb = commvol.pp_boundary_bytes(spec, pp.ranges)
        got = collections.Counter()
        count = collections.Counter()
        for e in log.entries:
            check(e.what == "handoff", f"commvol pp{n}: a {e.what} entry "
                  "(every head lies in the last stage)")
            got[e.position[0]] += e.nbytes
            count[e.position[0]] += 1
        live = [len(par_pp.carried_for_boundary(spec, stop))
                for _, stop in pp.ranges[:-1]]
        check([got[s] for s in range(1, n)] == [v * PAR_B for v in bb]
              and [count[s] for s in range(1, n)] == [v * PAR_B
                                                      for v in live],
              f"commvol pp{n}: handoffs {dict(got)} in {dict(count)} "
              f"entries, the live sets give {bb} in {live} a microbatch")
        pp_bytes[n] = bb
        res["pp"].append({"stages": n, "ranges": pp.ranges,
                          "launches": launches,
                          "boundary_bytes_img": bb, "live_tensors": live})
        say("commvol", f"int8 fused pp{n} {pp.ranges}: handoffs "
            + " / ".join(f"{v / 1e6:.3f}" for v in bb)
            + f" MB a image in {live} tensors = pp_boundary_bytes; heads "
            f"and launches ({launches}) the same with the recorder on and off")
        del pp
    # the compute anchors: one position, b=8, device time
    anchors = {"int8": anchor_ms(spec, params, mode),
               "bf16": anchor_ms(fspec, fparams, fmode,
                                 compute_dtype=torch.bfloat16)}
    del fparams
    labels = {key[0]: anchors["bf16" if key[0] == "sp" else "int8"]
              for key in wire}
    labels["pp"] = anchors["int8"]
    link = commvol.NVLINK_BW_H100_SXM
    rows = commvol.scaling_rows(wire, pp_bytes, labels, link)
    say("commvol", f"anchors on {smi_line}, b={COMM_ANCHOR_B}, one position: "
        f"int8 xla {anchors['int8']:.4f} ms a image, -bf16 "
        f"{anchors['bf16']:.4f}; link {link:.3g} B/s (NVIDIA's published "
        "H100 SXM NVLink figure, not measured: one card here)")
    for line in commvol.table_markdown(rows).splitlines():
        say("commvol", line)
    res.update({"card": smi_line, "anchors_ms_img": anchors,
                "anchor_batch": COMM_ANCHOR_B, "link_bw": link,
                "link_bw_source": "NVIDIA's published H100 SXM NVLink "
                                  "bandwidth (900 GB/s both directions; "
                                  "450e9 B/s received), not measured",
                "rows": rows})
    return res


def _v4_mish_classes() -> collections.Counter:
    """(B, H, W, C, M, ks, stride, pad) at b=1 -> how many of yolov4-416's
    int8 convs with mish have it (71 convs in 25 classes)."""
    spec = parse_network_cfg(V4_CFG, batch=1, quantized=True,
                             echo_table=False)
    ints = network._int8_layer_set(spec, "cpu")
    return collections.Counter(
        (1, l.h, l.w, l.c, l.n, l.size, l.stride, l.pad)
        for l in spec.conv_layers()
        if l.index in ints and l.activation == "mish")


def phase_v4_kernels() -> list:
    """K1's mish form (``csrc/int8_conv_mish.cu``) against its plain twin
    (``conv2d_int8_f32_plain(..., "mish")``: the linear epilogue, then
    ``F.mish``, on the card), bit for bit, in the cpu and the gpu epilogue,
    at yolov4-416's 25 mish classes; the cpu form (the path's) timed beside
    its bound, the leaky form at the same shape, the plain twin and
    ``torch._int_mm``."""
    dev = torch.device("cuda")
    rows = []
    for i, (shape, n) in enumerate(sorted(_v4_mish_classes().items())):
        b, h, w, c, m, ks, s, pad = shape
        label = f"{ks}x{ks}/s{s} {h}x{w}x{c}->{m}"
        xin, wt, bias = _form_operands(dev, SEED + i, shape, "f32")
        err = 0.0
        for form in ("f32/cpu/f32", "f32/gpu/f32"):
            out = _run_form(form, False, xin, wt, bias, s, pad, "mish")
            ref = _run_form(form, True, xin, wt, bias, s, pad, "mish")
            torch.cuda.synchronize()
            check(torch.equal(out, ref),
                  f"K1 mish form {form} != plain at {label}")
            err = max(err, float((out - ref).abs().max()))
        x8 = int8_conv.quantize_i8(xin, IN_MULT)
        a = im2col_int8(x8, ks, s, pad)
        wmat = wt.view(m, -1).t()
        row = {"shape": label, "count": n, "max_abs_err": err}
        row["ms"] = event_ms(lambda: _run_form(
            "f32/cpu/f32", False, xin, wt, bias, s, pad, "mish"))
        row["leaky_ms"] = event_ms(lambda: _run_form(
            "f32/cpu/f32", False, xin, wt, bias, s, pad, "leaky"))
        row["plain_ms"] = event_ms(lambda: _run_form(
            "f32/cpu/f32", True, xin, wt, bias, s, pad, "mish"), iters=10)
        row["library_ms"] = event_ms(lambda: torch._int_mm(a, wmat))
        oh, ow = ref.shape[1:3]
        p = b * oh * ow
        row["bound_ms"], row["bound_by"] = bound(
            4 * xin.numel() + wt.numel() + 4 * m + 4 * p * m,
            2.0 * p * m * ks * ks * c)
        rows.append(row)

    def total(key):
        return sum(r[key] * r["count"] for r in rows)
    say("yolov4", f"K1 mish form: bit-identical to plain (cpu and gpu "
        f"epilogue) at {len(rows)} classes of "
        f"{sum(r['count'] for r in rows)} convs; over the 71 at b=1 kernel {total('ms'):.4f} ms (leaky form "
        f"{total('leaky_ms'):.4f}), plain {total('plain_ms'):.4f}, "
        f"torch._int_mm {total('library_ms'):.4f} ms; bound "
        f"{total('bound_ms') * 1e3:.2f} us, "
        f"{100 * total('bound_ms') / total('ms'):.1f}% of it")
    return rows


def count_v4_mish_kernels() -> dict:
    """The device kernels with mish in their names in one warm yolov4-416
    int8 forward (random weights, seed 7) under torch.profiler, by kind:
    for a process of its own (``phase_yolov4``; profiler sessions late in
    a long process lost kernels)."""
    from torch.profiler import ProfilerActivity, profile
    spec, params, mode = detect.build_params(V4_CFG, None, quantized=True,
                                             seed=SEED, echo=False)
    pred = network.Predictor(spec, params, mode, device="cuda")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    pred(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # queued behind a device sleep, as in k6_profile
        torch.cuda._sleep(SLEEP_CYCLES // 5)
        pred(x)
        torch.cuda.synchronize()
    mish = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "mish" in e.name.lower()):
            mish["int8_conv_mish_kernel" if "int8_conv_mish_kernel" in e.name
                 else "other"] += 1
    return dict(mish)


def phase_yolov4() -> dict:
    """One yolov4-416 int8 forward at b=1 (random weights, seed 7): its
    K1 launches by form, counted from zero just before it (71
    ``f32/cpu/f32/mish``, 35 ``f32/cpu/f32``, nothing in front of them),
    the kernel path's heads equal to the plain path's on the card, and, in
    a fresh process, the device kernels with mish in their names: the 71
    of K1's mish form and conv0's ``F.mish`` (no separate mish pass)."""
    spec, params, mode = detect.build_params(V4_CFG, None, quantized=True,
                                             seed=SEED, echo=False)
    kernel = network.Predictor(spec, params, mode, device="cuda")
    plain = network.Predictor(spec, params, mode, device="cuda",
                              int8_impl="plain")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    hk = kernel(x)
    torch.cuda.synchronize()
    int8_conv.reset_launch_counts()
    hk2 = kernel(x)
    torch.cuda.synchronize()
    forms = dict(int8_conv.FORM_LAUNCHES)
    launches = int8_conv.LAUNCH_COUNTS["int8_conv"]
    pre = dict(int8_conv.PRE_LAUNCHES)
    check(forms == V4_FORMS, f"yolov4 K1 launches by form {forms}, "
          f"expected {V4_FORMS}")
    check(launches == 106 and not any(pre.values()),
          f"yolov4: {launches} int8_conv launches, {pre} in front")
    hp = plain(x)
    check([h.index for h in hk] == [139, 150, 161], "yolov4 head layers")
    for a, b, c in zip(hk, hp, hk2):
        check(bool(torch.isfinite(a.data).all()),
              f"yolov4 head {a.index} has non-finite values")
        check(torch.equal(a.data, b.data),
              f"yolov4 head {a.index}: kernel path != plain path")
        check(torch.equal(a.data, c.data),
              f"yolov4 head {a.index}: two kernel-path runs differ")
    k_ms = forward_ms(kernel, x)
    res = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke as cs; "
         "print(json.dumps(cs.count_v4_mish_kernels()))"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, "counting yolov4's mish kernels failed: "
          + res.stderr[-2000:])
    mish = json.loads(res.stdout.strip().splitlines()[-1])
    check(mish == {"int8_conv_mish_kernel": 71, "other": 1},
          f"yolov4 kernels named mish in a forward: {mish} (expected 71 of "
          "K1's mish form and conv0's F.mish)")
    say("yolov4", f"one forward: K1 {forms}, no launch in front; heads of "
        f"the kernel path == plain path (3 heads); device kernels named "
        f"mish {mish} (a process of its own); warm b=1 forward {k_ms:.3f} "
        "ms")
    return {"forms": forms, "launches": launches, "mish_kernels": mish,
            "forward_ms": k_ms}

def main() -> int:
    smi_line = phase_device()
    phase_build()
    rows = phase_kernels()
    fused_rows = phase_fused_kernels()
    names = [f"class_{i:02d}" for i in range(N_CLASSES)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        weights = os.path.join(tmp, "yolov3.weights")
        save_random_weights(CFG, weights, seed=SEED)
        names_file = os.path.join(tmp, "coco80.names")
        with open(names_file, "w") as f:
            f.write("\n".join(names) + "\n")
        launches, k1 = phase_int8(tmp, weights, names_file, names)
        fused_launches, fused_bounds = phase_fused(tmp, weights, names_file,
                                                   k1)
        k1_bound = k1["k1_bound"]
        del k1
        phase_fp32(tmp, weights, names_file)
        xnor_rows = phase_xnor_kernels()
        xnor_launches = phase_xnor(tmp)
        piped = phase_pipeline(tmp)
        form_rows = phase_precision_kernels()
        precision = phase_precision(tmp, weights, names_file, names)
        old_rows = phase_old_kernels()
        old = phase_old(tmp)
        bf16_rows = phase_bf16_kernels()
        bf16_run = phase_bf16(tmp, weights, names_file, names)
        slice11 = {"bf16": bf16_run, "demo": phase_demo(tmp),
                   "tree": phase_tree(tmp),
                   "profile": phase_profile(tmp, weights, names_file)}
        phase_nms_ops()
        parallel = phase_parallel(tmp, weights, names_file, names, smi_line)
        v4_rows = phase_v4_kernels()
        v4 = phase_yolov4()
        for mode, r in slice11["demo"].items():
            say("demo", f"{mode}: {r['fps']:.1f} frames per second over "
                f"{r['fps_frames']} frames (quarters "
                + " / ".join(f"{q:.1f}" for q in r["fps_quarters"])
                + f") on {smi_line}")
    k1 = {
        "kernel": "int8_conv", "route": "cuda", "source": KERNEL_SOURCE,
        "launches": launches,
        "launches_fused_path": fused_launches["int8_conv"],
        "bound_ms_per_forward": k1_bound,
        "bound_ms_per_fused_forward": fused_bounds["int8_conv"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "ms_int8_input": sum(r["ms_int8_input"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        **row_bound(rows),
        "library_ms": sum(r["library_ms"] for r in rows),
        "library": "torch._int_mm on the [P, ks*ks*C] x [ks*ks*C, M] "
                   "product, patches gathered beforehand, no epilogue",
        "shapes": rows}
    k2 = {
        "kernel": "fused_res_block", "route": "cuda", "source": FUSED_SOURCE,
        "launches": fused_launches["fused_res_block"],
        "bound_ms_per_forward": fused_bounds["fused_res_block"],
        "max_abs_err": max(r["max_abs_err"] for r in fused_rows),
        "ms": sum(r["ms"] for r in fused_rows),
        "plain_ms": sum(r["plain_ms"] for r in fused_rows),
        **row_bound(fused_rows),
        "library_ms": None,
        "unfused_ms": sum(r["unfused_ms"] for r in fused_rows),
        "shapes": fused_rows}
    # one row per TPU kernel; the two Pallas int8 convs (and the two fused
    # stage forms) compute one function each and share one Hopper kernel,
    # whose launches and times both rows carry
    kernels = [
        dict(name="conv3x3_int8_tiled", replaces=REPLACES, **k1),
        dict(name="conv3x3_int8_fused", replaces=ALSO_REPLACES,
             same_kernel_as="conv3x3_int8_tiled", **k1),
        dict(name="fused_res_stage", replaces=FUSED_REPLACES, **k2),
        dict(name="fused_res_stage_strips", replaces=FUSED_ALSO_REPLACES,
             same_kernel_as="fused_res_stage", **k2)]
    for (name, (source, replaces)), impl, engine in zip(
            XNOR_KERNELS.items(), ("pallas", "pallas_mxu"),
            ("popcount", "mxu")):
        kernels.append({
            "name": name, "kernel": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": xnor_launches[impl],
            "max_abs_err": max(r["max_abs_err"] for r in xnor_rows),
            "ms": sum(r[f"{name}_ms"] for r in xnor_rows),
            "plain_ms": sum(r[f"{name}_plain_ms"] for r in xnor_rows),
            **row_bound(xnor_rows),
            "library_ms": sum(r["library_ms"] for r in xnor_rows),
            "library": "torch._int_mm on the +-1 int8 [P, 9*C32*32] x "
                       "[9*C32*32, M] product, patches gathered and unpacked "
                       "beforehand, no epilogue",
            "dense_ms": sum(r["dense_ms"] for r in xnor_rows),
            "shapes": [{"shape": r["shape"], "plan": r["plans"][engine],
                        "ms": r[f"{name}_ms"],
                        "with_packing_ms": r[f"conv_{engine}_ms"],
                        "plain_ms": r[f"{name}_plain_ms"],
                        "library_ms": r["library_ms"],
                        "dense_ms": r["dense_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"]}
                       for r in xnor_rows]})
    # K1's forms on the precision modes' main path: the same kernel and TPU
    # kernel as K1's row, its launches in those forms
    for form, what in K1_PATH_FORMS.items():
        shapes = form_rows[form]
        kernels.append({
            "name": f"conv3x3_int8_tiled [{form}]", "kernel": "int8_conv",
            "form": form, "what": what, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": precision["form_launches"][form],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            **row_bound(shapes),
            "library_ms": sum(r["library_ms"] for r in shapes),
            "library": k1["library"], "shapes": shapes})
    # K1's old forms on the cpu_old path (yolov2-voc-416): their launches in
    # phase 10's detector test forward
    for form, what in OLD_PATH_FORMS.items():
        shapes = old_rows[form]
        kernels.append({
            "name": f"conv3x3_int8_tiled [{form}]", "kernel": "int8_conv",
            "form": form, "what": what, "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": old["detect"]["forms"][form],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            **row_bound(shapes),
            "library_ms": sum(r["library_ms"] for r in shapes),
            "library": k1["library"], "shapes": shapes})
    # K6: not a TPU kernel (it replaces XLA's bf16 conv); its launches are
    # those of phase 11's detector test -bf16 forward
    kernels.append({
        "name": "bf16_conv", "kernel": "bf16_conv", "route": "cuda",
        "source": BF16_SOURCE, "replaces": BF16_REPLACES,
        "launches": bf16_run["-bf16"]["launches"]["bf16_conv"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16_rows),
        "ms": sum(r["ms"] for r in bf16_rows),
        "plain_ms": sum(r["plain_ms"] for r in bf16_rows),
        **row_bound(bf16_rows),
        "library_ms": sum(r["library_ms"] for r in bf16_rows),
        "library": "cuDNN's bfloat16 conv (F.conv2d on bfloat16, its sum "
                   "rounded to bfloat16)",
        "f32_conv_ms": sum(r["f32_conv_ms"] for r in bf16_rows),
        "bare_ms": sum(r["bare_ms"] for r in bf16_rows),
        "per_forward": bf16_run["profile"],
        "shapes": bf16_rows})
    # the device NMS's two hand kernels (phase 8)
    kernels += piped["nms_kernels"]
    # K1's mish form (phase 13): the same TPU kernel as K1's row, its
    # launches in yolov4-416's forward
    kernels.append({
        "name": "conv3x3_int8_tiled [f32/cpu/f32/mish]",
        "kernel": "int8_conv_mish", "form": "f32/cpu/f32/mish",
        "what": "mish epilogue (yolov4's CSPDarknet53)", "route": "cuda",
        "source": MISH_SOURCE, "replaces": REPLACES,
        "launches": v4["forms"]["f32/cpu/f32/mish"],
        "max_abs_err": max(r["max_abs_err"] for r in v4_rows),
        **{k: sum(r[k] * r["count"] for r in v4_rows)
           for k in ("ms", "leaky_ms", "plain_ms", "library_ms")},
        **row_bound([dict(r, bound_ms=r["bound_ms"] * r["count"])
                     for r in v4_rows]),
        "library": k1["library"], "shapes": v4_rows})
    print(json.dumps({"slice11": slice11}), flush=True)
    print(json.dumps({"pipeline": piped}), flush=True)
    print(json.dumps({"precision": precision}), flush=True)
    print(json.dumps({"cpu_old": old}), flush=True)
    comm = parallel.pop("commvol")
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"commvol": comm}), flush=True)
    print(json.dumps({"yolov4": v4}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
