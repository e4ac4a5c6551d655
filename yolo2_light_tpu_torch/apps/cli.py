"""Command-line interface with the reference's usage, ``detector test``,
``detector map`` and ``detector calibrate`` (reference: main/run_detector,
src/main.c:584-667):

    python -m yolo2_light_tpu_torch detector test <names> <cfg> [weights] [image]
        [-thresh T] [-dont_show] [-quantized] [-int8_impl xla|pallas|fused]
        [-xnor_kernel int8|pallas|pallas_mxu|auto] [-letterbox] [-save PATH]
        [-int8_policy cpu|gpu|cpu_old] [-bf16|-fp32] [-turbo|-turbo_int8]
        [-device cuda|cpu]
    python -m yolo2_light_tpu_torch detector map <datacfg> <cfg> [weights]
        [-thresh T] [-iou_thresh F] [-quantized] [-int8_impl xla|pallas|fused]
        [-batch N] [-k N] [-device_nms] [-int8_policy cpu|gpu|cpu_old]
        [-bf16|-fp32] [-turbo|-turbo_int8] [-device cuda|cpu]
    python -m yolo2_light_tpu_torch detector calibrate <datacfg> <cfg>
        [weights] [-input_calibration N] [-calib_method device|host]
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
runs the plain PyTorch versions of the kernels.

Precision modes, as the JAX CLI's: ``-int8_policy gpu`` (with
``-quantized``) runs the reference's cuDNN INT8x4 flavor on the int8 conv
kernel (only the convs with the cfg's ``quantized`` flag are int8; no
requant, 0.1*y leaky); ``-bf16`` runs the float convs in bfloat16 (``-fp32``
is the default float32); ``-turbo`` materializes the activations between
layers as bfloat16 and ``-turbo_int8`` (with ``-quantized`` only) the
residual trunk as int8, both TPU-native extensions of the JAX package, not
reference semantics. ``-turbo`` and ``-turbo_int8`` together exit 1.
``-int8_policy cpu_old`` (with ``-quantized``) runs the reference's legacy
all-int8 chain (conv, maxpool, route, reorg and region layers only; the
int8 convs on the int8 conv kernel's "old" epilogue); it ignores
``-int8_impl``, ``-turbo`` and ``-bf16``, as the JAX package does.

``calibrate`` writes ``input_calibration.txt`` from the KL entropy
calibration of the fp32 forward's conv inputs over the first
``-input_calibration N`` images of the ``valid=`` list (1000 by default):
``-calib_method device`` (the default) sweeps on the device, ``host`` runs
the reference's bit-exact host sweep (``apps/calibrate.py``).

``demo`` and the JAX CLI's other flags (``-device_resize`` and
``-uint8_ingest``/``-no_uint8_ingest`` are demo flags) are not yet ported:
they exit non-zero and say so.
"""

from __future__ import annotations

import sys

_NOT_PORTED_FLAGS = ("-device_resize", "-uint8_ingest", "-no_uint8_ingest")
_NOT_PORTED_VALUES = ("-pp", "-pp_tp", "-parallel", "-tp",
                      "-sp", "-params_cache", "-profile", "-i",
                      "-c", "-s", "-prefix", "-out_filename")


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
    for flag in _NOT_PORTED_FLAGS + _NOT_PORTED_VALUES:
        if flag in args:
            raise NotImplementedError(
                f"{flag} is not yet ported to yolo2_light_tpu_torch")

    dont_show = _find_flag(args, "-dont_show")
    bf16 = _find_flag(args, "-bf16")
    _find_flag(args, "-fp32")   # float32 convs: the default of test and map
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
    device_nms = _find_flag(args, "-device_nms")
    batch = _find_value(args, "-batch", 0, int)
    topk = _find_value(args, "-k", 0, int)   # candidate-buffer K (map)
    save_path = _find_value(args, "-save", "predictions")
    int8_policy = _find_value(args, "-int8_policy", "cpu")
    int8_impl = _find_value(args, "-int8_impl", "xla")
    xnor_kernel = _find_value(args, "-xnor_kernel", "int8")
    device = _find_value(args, "-device", "cuda")
    input_calibration = _find_value(args, "-input_calibration", 0, int)
    calib_method = _find_value(args, "-calib_method", "device")
    if int8_impl not in ("xla", "pallas", "fused"):
        raise ValueError(f"unknown int8_impl {int8_impl!r} "
                         "(expected xla, pallas or fused)")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unknown device {device!r} (expected cuda or cpu)")

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
    if sub == "demo":
        raise NotImplementedError(
            f"detector {sub} is not yet ported to yolo2_light_tpu_torch")
    if sub not in ("test", "map", "calibrate"):
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
    compute_dtype = torch.bfloat16 if bf16 else None
    if device == "cuda":
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
    if sub == "map":
        from .map import validate_detector_map
        kw = {}
        if batch > 0:
            kw["batch"] = batch
        if topk > 0:
            kw["k"] = topk
        validate_detector_map(obj_names, cfg, weights, thresh=thresh,
                              quantized=quantized, iou_thresh=iou_thresh,
                              int8_policy=int8_policy, device_nms=device_nms,
                              int8_impl=int8_impl, device=device,
                              compute_dtype=compute_dtype, turbo=turbo, **kw)
        return 0
    from ..datacfg import load_names
    from .detect import run
    names = load_names(obj_names)
    run(names, cfg, weights, filename, thresh=thresh, quantized=quantized,
        dont_show=dont_show, int8_policy=int8_policy, save_path=save_path,
        letter=letterbox, int8_impl=int8_impl, xnor_impl=xnor_kernel,
        device=device, compute_dtype=compute_dtype, turbo=turbo)
    return 0


if __name__ == "__main__":
    sys.exit(main())
