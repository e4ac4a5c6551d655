"""Command-line interface with the reference's usage, ``detector test``,
``detector map``, ``detector calibrate`` and ``detector demo`` (reference:
main/run_detector, src/main.c:584-667):

    python -m yolo2_light_tpu_torch detector test <names> <cfg> [weights] [image]
        [-thresh T] [-dont_show] [-quantized] [-int8_impl xla|pallas|fused]
        [-xnor_kernel int8|pallas|pallas_mxu|auto] [-letterbox] [-save PATH]
        [-int8_policy cpu|gpu|cpu_old] [-bf16|-fp32] [-turbo|-turbo_int8]
        [-params_cache DIR] [-profile DIR] [-pp S [-pp_tp T]] [-i N]
        [-device cuda|cpu]
    python -m yolo2_light_tpu_torch detector map <datacfg> <cfg> [weights]
        [-thresh T] [-iou_thresh F] [-quantized] [-int8_impl xla|pallas|fused]
        [-batch N] [-k N] [-device_nms] [-int8_policy cpu|gpu|cpu_old]
        [-bf16|-fp32] [-turbo|-turbo_int8] [-params_cache DIR]
        [-device_resize] [-parallel N] [-tp M] [-sp K] [-pp S [-pp_tp T]]
        [-profile DIR] [-i N] [-device cuda|cpu]
    python -m yolo2_light_tpu_torch detector calibrate <datacfg> <cfg>
        [weights] [-input_calibration N] [-calib_method device|host]
        [-i N] [-device cuda|cpu]
    python -m yolo2_light_tpu_torch detector demo <names> <cfg> [weights]
        [video] [-thresh T] [-dont_show] [-quantized] [-bf16|-fp32]
        [-c CAM] [-s FRAME_SKIP] [-prefix P] [-out_filename F] [-batch N]
        [-k N] [-device_nms] [-device_resize] [-uint8_ingest|-no_uint8_ingest]
        [-params_cache DIR] [-int8_policy ..] [-int8_impl ..]
        [-turbo|-turbo_int8] [-pp S [-pp_tp T]] [-profile DIR] [-i N]
        [-device cuda|cpu]

``-int8_impl fused`` runs each darknet53 residual block as one launch of the
fused kernel; ``xla`` and ``pallas`` run every int8 conv on the int8 conv
kernel. ``-xnor_kernel`` picks the engine of the XNOR convs: ``int8`` (the
default) the dense +-1 conv, ``pallas`` the popcount kernel, ``pallas_mxu``
the bit-packed int8 kernel, ``auto`` the faster of the last and the dense
conv per layer. ``map`` runs the serving pipeline (``pipeline.py``, one CUDA
graph per batch shape): ``-batch N`` images a batch (default 8), ``-k N`` the
initial candidate buffer (default 1024; a saturated buffer grows to the
net's total candidate count, or 4096 with ``-device_nms``), ``-device_nms``
the exact greedy NMS on the device. ``-device`` defaults to ``cuda``; ``cpu``
runs the plain PyTorch versions of the kernels; ``-i N`` picks the N-th
device of that kind (``cuda:N``), and an index out of range exits 1.

Precision modes, as the JAX CLI's: ``-int8_policy gpu`` (with
``-quantized``) runs the reference's cuDNN INT8x4 flavor on the int8 conv
kernel (only the convs with the cfg's ``quantized`` flag are int8; no
requant, 0.1*y leaky); ``-bf16`` runs the float convs on bfloat16 operands
with float32 sums (the bf16 conv kernel); ``-fp32`` is float32, the default
of test and map; ``-turbo`` materializes the activations between layers as
bfloat16 and ``-turbo_int8`` (with ``-quantized`` only) the residual trunk
as int8, both TPU-native extensions of the JAX package, not reference
semantics. ``-turbo`` and ``-turbo_int8`` together exit 1.
``-int8_policy cpu_old`` (with ``-quantized``) runs the reference's legacy
all-int8 chain (conv, maxpool, route, reorg and region layers only; the
int8 convs on the int8 conv kernel's "old" epilogue); it ignores
``-int8_impl``, ``-turbo`` and ``-bf16``, as the JAX package does.

``calibrate`` writes ``input_calibration.txt`` from the KL entropy
calibration of the fp32 forward's conv inputs over the first
``-input_calibration N`` images of the ``valid=`` list (1000 by default):
``-calib_method device`` (the default) sweeps on the device, ``host`` runs
the reference's bit-exact host sweep (``apps/calibrate.py``).

``demo`` (``apps/demo.py``) runs a video file or camera through the
pipeline's stream, in bfloat16 by default (``-fp32``: float32 and float
ingest); it needs OpenCV only for a codec, a window, ``-out_filename`` or
``-prefix``. ``-params_cache DIR`` keeps the transformed params (test and
demo, the JAX package's cache key); ``-profile DIR`` (test, map, demo)
writes a ``torch.profiler`` trace of the run into ``DIR/trace.json`` (host
operations and, on the card, kernels and copies). Under map and demo,
which run the serving pipeline, the same file holds the pipeline's own
spans (each request's dispatch and collect and their parts) on a track
named ``yolo2_light_tpu_torch spans``, and as counter events its counters
(images, candidates, H2D bytes) and the device ms of each stage of each
graph replay (``utils/profiling.py``); ``detector test`` runs the eager
``Predictor``, which records no spans.

The multi-device flags, as the JAX CLI's (``parallel/``): ``-parallel N``,
``-tp M`` and ``-sp K`` (map) run the pipeline on a mesh of N*K*M device
positions (data, space and model axes); ``-pp S`` (test, map, demo) runs the
network as S pipeline stages and ``-pp_tp T`` (with ``-pp`` only) makes each
stage T positions wide. On ``-device cuda`` the positions are ``cuda:0 ..``,
so the flags need that many GPUs (fewer exit 1 with the JAX CLI's message);
on ``-device cpu`` every position is the CPU. ``map`` takes
``-params_cache`` and ignores ``-device_resize``, as the JAX CLI does.
"""

from __future__ import annotations

import sys


def _find_flag(args, name):
    if name in args:
        args.remove(name)
        return True
    return False


def _find_value(args, name, default, cast=str):
    if name in args:
        i = args.index(name)
        val = args[i + 1]
        del args[i:i + 2]
        return cast(val)
    return default


def main(argv=None) -> int:
    try:
        return _main(argv)
    except FileNotFoundError as e:
        # reference: file_error() prints and exit(0)s
        # (src/additionally.c:1610-1614)
        print(f"Couldn't open file: {e.filename or e}", file=sys.stderr)
        return 0
    except (ValueError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) < 1:
        print("usage: yolo2_light_tpu_torch <function>", file=sys.stderr)
        return 0
    if args[0] != "detector":
        print(f"Not an option: {args[0]}", file=sys.stderr)
        return 1
    args = args[1:]

    dont_show = _find_flag(args, "-dont_show")
    bf16 = _find_flag(args, "-bf16")
    fp32 = _find_flag(args, "-fp32")  # the default of test and map; demo's
    #                                   float32 and float-ingest path
    turbo = _find_flag(args, "-turbo")
    turbo_int8 = _find_flag(args, "-turbo_int8")
    if turbo and turbo_int8:
        print("error: -turbo and -turbo_int8 are mutually exclusive (bf16 "
              "vs int8 residual materialization)", file=sys.stderr)
        return 1
    if turbo_int8:
        turbo = "int8"   # the rung below -turbo: int8 residual trunk
    quantized = _find_flag(args, "-quantized")
    if turbo_int8 and not quantized:
        print("error: -turbo_int8 requires -quantized (the residual trunk "
              "quantizes at the int8 convs' calibrated input multipliers)",
              file=sys.stderr)
        return 1
    letterbox = _find_flag(args, "-letterbox")
    thresh = _find_value(args, "-thresh", 0.25, float)
    iou_thresh = _find_value(args, "-iou_thresh", 0.5, float)
    cam_index = _find_value(args, "-c", 0, int)       # src/main.c:591
    frame_skip = _find_value(args, "-s", 0, int)      # src/main.c:594
    prefix = _find_value(args, "-prefix", None)
    out_filename = _find_value(args, "-out_filename", None)
    device_nms = _find_flag(args, "-device_nms")
    device_resize = _find_flag(args, "-device_resize")
    # demo's ingest precision (default: uint8 under bf16, float otherwise)
    uint8_ingest = None
    if _find_flag(args, "-uint8_ingest"):
        uint8_ingest = True
    if _find_flag(args, "-no_uint8_ingest"):
        uint8_ingest = False
    batch = _find_value(args, "-batch", 0, int)
    topk = _find_value(args, "-k", 0, int)   # candidate-buffer K (map)
    save_path = _find_value(args, "-save", "predictions")
    int8_policy = _find_value(args, "-int8_policy", "cpu")
    int8_impl = _find_value(args, "-int8_impl", "xla")
    xnor_kernel = _find_value(args, "-xnor_kernel", "int8")
    device = _find_value(args, "-device", "cuda")
    device_index = _find_value(args, "-i", 0, int)
    input_calibration = _find_value(args, "-input_calibration", 0, int)
    calib_method = _find_value(args, "-calib_method", "device")
    params_cache = _find_value(args, "-params_cache", None)
    data_parallel = _find_value(args, "-parallel", 0, int)
    tensor_parallel = _find_value(args, "-tp", 0, int)
    spatial_parallel = _find_value(args, "-sp", 0, int)
    pipeline_parallel = _find_value(args, "-pp", 0, int)
    pp_tensor_parallel = _find_value(args, "-pp_tp", 1, int)
    profile_dir = _find_value(args, "-profile", None)
    if pp_tensor_parallel > 1 and pipeline_parallel <= 1:
        # -pp_tp is only consumed inside pipeline stages; silently ignoring
        # it would give a user who asked for tensor sharding a one-device run
        print("error: -pp_tp requires -pp S with S > 1 (tensor parallelism "
              "inside pipeline stages); for a global tensor axis use -tp",
              file=sys.stderr)
        return 1
    if int8_impl not in ("xla", "pallas", "fused"):
        raise ValueError(f"unknown int8_impl {int8_impl!r} "
                         "(expected xla, pallas or fused)")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r} (expected cuda or cpu)")
    if device_index:
        # reference: -i selects the GPU (src/main.c:653-661)
        import torch
        count = (torch.cuda.device_count() if device == "cuda" else 1)
        if not 0 <= device_index < count:
            print(f"device index {device_index} out of range "
                  f"({count} devices)", file=sys.stderr)
            return 1
        device = f"{device}:{device_index}"

    if len(args) < 2:
        print("usage: yolo2_light_tpu_torch detector [test/map/calibrate/demo] "
              "[names/datacfg] [cfg] [weights (optional)]", file=sys.stderr)
        return 1
    sub = args[0]
    if device_nms and sub in ("test", "calibrate"):
        # -device_nms is only consumed by map/demo (the test app is the
        # host-post oracle path); silently ignoring it would tell a user
        # their NMS ran on the device when it did not
        print("error: -device_nms applies to detector map/demo only "
              "(detector test uses the reference host post-processing path)",
              file=sys.stderr)
        return 1
    if sub not in ("test", "map", "calibrate", "demo"):
        print(f"Not an option: {sub}", file=sys.stderr)
        return 1
    obj_names = args[1]
    cfg = args[2] if len(args) > 2 else None
    weights = args[3] if len(args) > 3 else None
    filename = args[4] if len(args) > 4 else None
    if cfg is None:
        print("error: missing cfg file", file=sys.stderr)
        return 1
    import torch
    compute_dtype = (torch.bfloat16 if bf16
                     else torch.float32 if fp32 and sub == "demo" else None)
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("error: CUDA is not available; pass -device cpu to run the "
                  "plain PyTorch path", file=sys.stderr)
            return 1

    if sub == "calibrate":
        if bf16:
            print("note: calibrate always runs fp32 (calibration statistics "
                  "are precision-sensitive); -bf16 ignored", file=sys.stderr)
        if calib_method == "device":
            # the device sweep can land one threshold bin off the
            # reference's serial accumulation (about 0.03% of a multiplier);
            # the host method is the bit-exact one (quant.py)
            print("note: -calib_method device (default) is fast but may "
                  "differ from the reference by one threshold bin; use "
                  "-calib_method host for bit-exact calibration",
                  file=sys.stderr)
        from .calibrate import validate_calibrate
        validate_calibrate(obj_names, cfg, weights,
                           input_calibration=input_calibration,
                           method=calib_method, device=device)
        return 0
    import contextlib
    tracing = contextlib.nullcontext()
    if profile_dir:
        from ..utils.profiling import trace
        tracing = trace(profile_dir)
    if sub == "map":
        from .map import validate_detector_map
        kw = {}
        if batch > 0:
            kw["batch"] = batch
        if topk > 0:
            kw["k"] = topk
        with tracing:
            validate_detector_map(
                obj_names, cfg, weights, thresh=thresh, quantized=quantized,
                iou_thresh=iou_thresh, int8_policy=int8_policy,
                device_nms=device_nms, int8_impl=int8_impl, device=device,
                compute_dtype=compute_dtype, turbo=turbo,
                data_parallel=data_parallel, tensor_parallel=tensor_parallel,
                spatial_parallel=spatial_parallel,
                pipeline_parallel=pipeline_parallel, pp_tp=pp_tensor_parallel,
                params_cache=params_cache, **kw)
        return 0
    from ..datacfg import load_names
    names = load_names(obj_names)
    if sub == "demo":
        from .demo import demo
        with tracing:
            demo(cfg, weights, thresh, filename, names, quantized=quantized,
                 out_filename=out_filename, dont_show=dont_show,
                 int8_policy=int8_policy, compute_dtype=compute_dtype,
                 prefix=prefix, cam_index=cam_index, frame_skip=frame_skip,
                 batch=batch, params_cache=params_cache,
                 device_nms=device_nms, uint8_ingest=uint8_ingest,
                 turbo=turbo, int8_impl=int8_impl,
                 device_resize=device_resize, device=device,
                 pipeline_parallel=pipeline_parallel,
                 pp_tp=pp_tensor_parallel,
                 **({"k": topk} if topk > 0 else {}))
        return 0
    from .detect import run
    with tracing:
        run(names, cfg, weights, filename, thresh=thresh, quantized=quantized,
            dont_show=dont_show, int8_policy=int8_policy,
            save_path=save_path, letter=letterbox, int8_impl=int8_impl,
            xnor_impl=xnor_kernel, device=device,
            compute_dtype=compute_dtype, turbo=turbo,
            params_cache=params_cache, pp_stages=pipeline_parallel,
            pp_tp=pp_tensor_parallel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
