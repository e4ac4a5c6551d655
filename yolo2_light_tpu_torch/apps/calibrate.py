"""``detector calibrate`` app: INT8 ``input_calibration`` scales by KL
entropy calibration over a dataset.

Counterpart of ``yolo2_light_tpu/apps/calibrate.py`` (reference:
validate_calibrate_valid, src/additionally.c:4902-5001, and
network_calibrate_cpu, src/yolov2_forward_network.c:731-831), with its
streams, its file and its quirks:

* per image, per conv layer: multiplier = entropy_calibration(conv input,
  1/16, 4096);
* the multiplier of image k (k = 1..max_num) lands in slot ``k + i*max_num``
  of a flat array (i the LAYER index), so image max_num's multiplier of layer
  i lands in layer i+1's slot 0;
* the saved value is the mean of slots 0..max_num-1 of the layer's stripe:
  the mean over images 1..max_num-1 of this layer plus, for conv layers after
  the first, the final-image multiplier of the previous layer;
* the file is written after max_num images (the reference writes it on image
  max_num+1 only, the JAX package's documented deviation), and the forward is
  the full fp32 one (the reference's calibration forward leaves upsample,
  shortcut and yolo outputs zero; for nets of conv, maxpool, route, reorg and
  region layers the two agree).

Images stream one at a time. ``-calib_method device`` (the default) runs
the fp32 forward with its conv inputs captured, their histograms
(``quant.activation_histogram``) and the KL sweep
(``quant.entropy_calibration_multipliers``) on the device, eagerly, and
brings back one float per conv; ``host`` brings back every conv input and
runs the reference's sweep on the host (``quant.entropy_calibration``,
bit-exact).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..cfg import ConvSpec
from ..datacfg import read_data_cfg
from ..io import image as im_io
from ..models.network import build_forward, device_params
from ..quant import (activation_histogram, entropy_calibration,
                     entropy_calibration_multipliers)
from .detect import build_params


def calibrate_multipliers(spec, params, image_arrays, max_num: int,
                          method: str = "device", device="cuda") -> list:
    """Run calibration over ``image_arrays`` (an iterable of [H, W, C]
    float32 images at the net's size, consumed lazily); returns the saved
    multiplier of each conv layer (the reference's accumulator semantics).
    ``params``: the host params (``apps.detect.build_params``).
    ``max_num``: the number of images used (the reference's default is
    1000). ``method``: "device" or "host" (module docstring). ``device``:
    where the forward runs; a CUDA device is required unless "cpu" is
    asked for."""
    if method not in ("device", "host"):
        raise ValueError(f"unknown calibration method {method!r} (expected "
                         "device or host)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (use device='cpu' to run "
                           "the plain PyTorch path)")
    fwd = build_forward(spec, "fp32", capture_conv_inputs=True)
    dev_params = device_params(spec, params, "fp32", device)

    def conv_inputs(img):
        x = torch.from_numpy(np.ascontiguousarray(img[None])).to(device)
        with torch.inference_mode():
            return fwd(dev_params, x)[1]["conv_inputs"]

    conv_specs = [l for l in spec.layers if isinstance(l, ConvSpec)]
    conv_indices = [l.index for l in conv_specs]
    conv_sizes = [l.inputs for l in conv_specs]
    n_stripes = spec.n + 1  # +1: the last conv's image-max_num write spills
    arr = np.zeros(n_stripes * max_num, np.float32)

    counter = 0
    for img in image_arrays:
        if counter >= max_num:
            break
        if counter % 4 == 0:
            # loader-batch progress (the reference's nthreads=4 pipeline
            # prints the leading image index per batch, additionally.c:4955)
            print(f"{counter + 4}", file=sys.stderr)
        counter += 1
        inputs = conv_inputs(img)
        mults = None
        if method == "device":
            with torch.inference_mode():
                hists = torch.stack([activation_histogram(ci)
                                     for ci in inputs])
                mults = entropy_calibration_multipliers(hists).cpu().numpy()
        for k, (li, size) in enumerate(zip(conv_indices, conv_sizes)):
            if mults is None:
                # host sweep per layer, its " mult = ..." line printed right
                # before this layer's " multiplier = ..." line, as the
                # reference's in-place call (yolov2_forward_network.c:787-788)
                mult = float(entropy_calibration(
                    inputs[k].cpu().numpy(), 1.0 / 16, 4096, echo=True))
            else:
                mult = float(mults[k])
            # reference printf -> stdout (yolov2_forward_network.c:788)
            print(f" multiplier = {mult:f}, l.inputs = {size} \n")
            # indexed by LAYER index i, not conv ordinal: the stripes follow
            # layer indices (src/yolov2_forward_network.c:792)
            arr[counter + li * max_num] = mult
            if counter >= max_num:
                stripe_vals = arr[li * max_num: li * max_num + max_num]
                res = float(stripe_vals.mean())
                arr[li * max_num] = res
                print(f" res_mult = {res:f}, max_num = {max_num} ")
    if counter == max_num and max_num % 4 == 0:
        # the reference's save triggers on the (max_num+1)th image, whose
        # loader batch prints its index before the exit (additionally.c:4955)
        print(f"{max_num + 4}", file=sys.stderr)
    return [float(arr[li * max_num]) for li in conv_indices]


def validate_calibrate(datacfg: str, cfgfile: str, weightfile, *,
                       input_calibration: int = 0,
                       out_path: str = "input_calibration.txt",
                       method: str = "device", device="cuda") -> list:
    """The app: read the ``valid=`` list of ``datacfg``, calibrate over its
    first ``input_calibration`` images (1000 when 0), write the
    ``input_calibration = ..., 16`` line to ``out_path`` (no trailing
    newline, as the reference) and print it."""
    options = read_data_cfg(datacfg)
    valid_images = options.get("valid", "data/train.txt")
    print(f"valid={valid_images} ")        # printf -> stdout (additionally.c:4907)
    if not input_calibration:
        print("\n -input_calibration <number> - isn't specified in command "
              "line, will be used 1000 images \n")   # additionally.c:4912
        input_calibration = 1000

    spec, params, _ = build_params(cfgfile, weightfile, quantized=False)
    with open(valid_images) as f:
        paths = [l.strip() for l in f if l.strip()]
    max_num = min(input_calibration, len(paths))

    # streamed: one image in flight at a time
    imgs = (im_io.resize_image(im_io.load_image(p, 3), spec.net.w, spec.net.h)
            for p in paths[:max_num])
    mults = calibrate_multipliers(spec, params, imgs, max_num, method=method,
                                  device=device)

    # the reference prints the save banner, then each value as it writes the
    # file, ending "16 \n ---------------------------" with no trailing
    # newline (yolov2_forward_network.c:754-771)
    print("\n\n Saving coefficients to the input_calibration.txt file... \n")
    line = "input_calibration = " + "".join(f"{m:g}, " for m in mults) + "16"
    with open(out_path, "w") as f:
        f.write(line)
    print(line + " \n ---------------------------", end="", flush=True)
    return mults
