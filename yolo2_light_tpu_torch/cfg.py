# Mirrors yolo2_light_tpu/cfg.py: a copy, so that the port imports
# nothing of the JAX package; it adds yolov4's mish and [yolo] options.
"""Darknet ``.cfg`` model-description parser.

Produces a typed, immutable :class:`ModelSpec` (a list of per-layer dataclasses with
fully resolved input/output dimensions) from a darknet INI-style config file.

Behavioral parity notes (reference: AlexeyAB/yolo2_light, read-only mount):

* Section/option grammar: ``read_cfg`` (``src/additionally.c:3423-3456``) — ``[section]``
  headers, ``key=value`` options, ``#``/``;``/empty lines skipped, whitespace and ``\\0x0d``
  stripped everywhere (darknet's ``strip()`` removes ALL whitespace, even interior).
* Layer dimension chaining: ``parse_network_cfg`` (``src/additionally.c:3955-4084``).
* Conv quantization-eligibility rules: ``parse_convolutional``
  (``src/additionally.c:3558-3559``) — layer 0, LINEAR activation, stride>1 after index 1,
  or 1x1 convs are never INT8-eligible; additionally the conv whose next-next section is a
  ``[yolo]`` head *permanently* disables eligibility for itself and every later conv
  (``src/additionally.c:3996-4004`` mutates ``params.quantized`` without restoring it).
  These flags drive the reference's GPU INT8 path; its CPU INT8 path instead quantizes
  every conv except layer 0 / LINEAR (``src/yolov2_forward_network_quantized.c:1036``).
* Out-dims: conv ``(h + 2*pad - size)/stride + 1`` (``src/additionally.c:2712-2719``),
  maxpool ``(h + pad - size)/stride + 1`` with default ``padding = size-1``
  (``src/additionally.c:2604-2612``, ``:3706-3708``), reorg (``src/additionally.c:2409-2418``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Activations (reference: src/additionally.h:66-131)
# ---------------------------------------------------------------------------

# the string mapping recognizes 13 names (src/additionally.h:108-123); notably
# "selu" has an activate() case but is NOT reachable from a cfg file. The
# port adds "mish", which AlexeyAB/darknet's yolov4.cfg uses
# (activate_array_mish, src/activations.c there; yolo2_light has none)
ACTIVATIONS = (
    "logistic", "loggy", "relu", "elu", "relie", "plse", "hardtan", "lhtan",
    "linear", "ramp", "leaky", "tanh", "stair", "mish",
)


def get_activation(name: str) -> str:
    """Map activation name to canonical form; unknown names fall back to relu with a
    warning (reference: get_activation, src/additionally.h:112-124)."""
    if name in ACTIVATIONS:
        return name
    import sys
    print(f"Couldn't find activation function {name}, going with ReLU",
          file=sys.stderr)
    return "relu"


# ---------------------------------------------------------------------------
# Raw INI reading
# ---------------------------------------------------------------------------

@dataclass
class Section:
    type: str                 # e.g. "[convolutional]" (brackets kept, like the reference)
    options: dict             # key -> raw string value
    used: set = field(default_factory=set)

    def find(self, key: str, default=None):
        self.used.add(key)
        return self.options.get(key, default)

    def _default(self, key, default, quiet, fmt):
        # non-quiet option_find_* variants announce fallbacks on stderr
        # (reference: option_find_int/float/str, src/additionally.c:3358-3398)
        if not quiet:
            import sys
            print(f"{key}: Using default '{fmt}'", file=sys.stderr)
        return default

    def find_int(self, key: str, default: int, quiet: bool = True) -> int:
        v = self.find(key)
        return int(v) if v is not None else self._default(key, default, quiet,
                                                          f"{default:d}")

    def find_float(self, key: str, default: float, quiet: bool = True) -> float:
        v = self.find(key)
        return float(v) if v is not None else self._default(key, default, quiet,
                                                            f"{default:f}")

    def find_str(self, key: str, default: Optional[str],
                 quiet: bool = True) -> Optional[str]:
        v = self.find(key)
        if v is not None:
            return v
        # reference option_find_str only prints when the default is non-null
        return self._default(key, default, quiet or default is None,
                             default)

    def unused_keys(self):
        return [k for k in self.options if k not in self.used]


def _strip(line: str) -> str:
    # darknet's strip() removes every whitespace char anywhere in the line
    # (reference: src/additionally.c:1654-1666)
    return "".join(ch for ch in line if ch not in " \t\n\r")


def read_cfg_sections(path: str) -> list[Section]:
    """Parse an INI file into sections (reference: read_cfg, src/additionally.c:3423)."""
    sections: list[Section] = []
    current: Optional[Section] = None
    with open(path, "r") as f:
        for nu, raw in enumerate(f, 1):
            line = _strip(raw)
            if not line or line[0] in "#;":
                continue
            if line[0] == "[":
                current = Section(type=line, options={})
                sections.append(current)
            else:
                if "=" not in line or current is None:
                    # reference prints "Config file error line %d" and drops the line
                    continue
                key, _, val = line.partition("=")
                current.options[key] = val
    return sections


def _parse_float_list(s: str) -> list[float]:
    return [float(tok) for tok in s.split(",") if tok != ""]


def _parse_int_list(s: str) -> list[int]:
    return [int(tok) for tok in s.split(",") if tok != ""]


# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerSpec:
    index: int = -1
    # input dims (w,h,c) and output dims, resolved during parsing
    w: int = 0
    h: int = 0
    c: int = 0
    out_w: int = 0
    out_h: int = 0
    out_c: int = 0

    @property
    def inputs(self) -> int:
        return self.w * self.h * self.c

    @property
    def outputs(self) -> int:
        return self.out_w * self.out_h * self.out_c


@dataclass(frozen=True)
class ConvSpec(LayerSpec):
    n: int = 1                  # filters
    size: int = 1
    stride: int = 1
    pad: int = 0                # resolved padding (pixels)
    activation: str = "logistic"
    batch_normalize: bool = False
    binary: bool = False
    xnor: bool = False
    bin_output: bool = False
    quantized: bool = False     # INT8-eligibility per reference GPU rules
    flipped: int = 0
    dontload: bool = False        # loader skips this layer's weights entirely
    dontloadscales: bool = False  # loader skips the BN stats (scales/mean/var)

    @property
    def bflops(self) -> float:
        # reference: src/additionally.c:2903-2907
        return (2.0 * self.n * self.size * self.size * self.c
                * self.out_h * self.out_w) / 1e9


@dataclass(frozen=True)
class MaxpoolSpec(LayerSpec):
    size: int = 1
    stride: int = 1
    pad: int = 0                # darknet 'padding' (total, asymmetric; default size-1)


@dataclass(frozen=True)
class RouteSpec(LayerSpec):
    layers: tuple = ()          # absolute source layer indices
    input_sizes: tuple = ()

    @property
    def outputs(self) -> int:
        # route outputs = sum of source sizes even when spatial dims mismatch
        # (reference: make_route_layer, src/additionally.c:2461-2466)
        return sum(self.input_sizes)


@dataclass(frozen=True)
class ReorgSpec(LayerSpec):
    stride: int = 1
    reverse: bool = False


@dataclass(frozen=True)
class UpsampleSpec(LayerSpec):
    stride: int = 2
    scale: float = 1.0


@dataclass(frozen=True)
class ShortcutSpec(LayerSpec):
    from_index: int = 0         # absolute source layer index
    activation: str = "linear"


@dataclass(frozen=True)
class YoloSpec(LayerSpec):
    n: int = 1                  # anchors used at this head (len(mask))
    total: int = 1              # total anchors
    mask: tuple = ()
    classes: int = 20
    anchors: tuple = ()         # 2*total floats (pixels)
    max_boxes: int = 90
    jitter: float = 0.2
    ignore_thresh: float = 0.5
    truth_thresh: float = 1.0
    random: int = 0
    focal_loss: int = 0
    class_map: tuple = None     # map= file contents (src/additionally.c:3662-3663);
                                # parsed but unused in yolo decode, like the reference
    scale_x_y: float = 1.0      # AlexeyAB/darknet's (yolov4): x, y after the
                                # logistic become x * s - (s - 1) / 2


@dataclass(frozen=True)
class RegionSpec(LayerSpec):
    n: int = 1                  # anchors
    classes: int = 20
    coords: int = 4
    anchors: tuple = ()         # 2*n floats (grid units)
    softmax: bool = False
    max_boxes: int = 30
    thresh: float = 0.5
    classfix: int = 0
    jitter: float = 0.2
    rescore: int = 0
    bias_match: int = 0
    softmax_tree: object = None        # Tree (yolo2_light_tpu.tree) or None
    class_map: tuple = None     # map= class-index list (src/additionally.c:3603-3604);
                                # drives the YOLO9000 tree decode when supplied
    # training-only aux options, accepted for cfg parity (src/additionally.c:3582-3599)
    log: int = 0
    sqrt: int = 0
    absolute: int = 0
    random: int = 0
    coord_scale: float = 1.0
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0


@dataclass(frozen=True)
class SoftmaxSpec(LayerSpec):
    groups: int = 1
    temperature: float = 1.0
    softmax_tree: object = None  # tree= (reference: parse_softmax,
                                 # src/additionally.c:3695-3696)


@dataclass(frozen=True)
class NetSpec:
    """[net] section (reference: parse_net_options, src/additionally.c:3858-3952)."""
    batch: int = 1
    w: int = 0
    h: int = 0
    c: int = 0
    inputs: int = 0
    subdivisions: int = 1
    input_calibration: tuple = ()


@dataclass(frozen=True)
class ModelSpec:
    net: NetSpec
    layers: tuple  # tuple[LayerSpec]

    @property
    def n(self) -> int:
        return len(self.layers)

    def conv_layers(self):
        return [l for l in self.layers if isinstance(l, ConvSpec)]

    @property
    def outputs(self) -> int:
        # reference: get_network_output_size = last non-COST layer's outputs
        return self.layers[-1].outputs

    def head_indices(self) -> list[int]:
        return [l.index for l in self.layers
                if isinstance(l, (YoloSpec, RegionSpec))]


# ---------------------------------------------------------------------------
# Section -> spec parsers
# ---------------------------------------------------------------------------

_LAYER_TYPE_NAMES = {
    "[yolo]": "yolo",
    "[region]": "region",
    "[conv]": "convolutional",
    "[convolutional]": "convolutional",
    "[net]": "net",
    "[network]": "net",
    "[max]": "maxpool",
    "[maxpool]": "maxpool",
    "[reorg]": "reorg",
    "[upsample]": "upsample",
    "[shortcut]": "shortcut",
    "[soft]": "softmax",
    "[softmax]": "softmax",
    "[route]": "route",
}


def section_layer_type(section_type: str) -> str:
    """reference: string_to_layer_type (src/additionally.c:3824-3844)."""
    return _LAYER_TYPE_NAMES.get(section_type, "blank")


def _parse_net(s: Section) -> NetSpec:
    """[net] options with reference lookup order/loudness (parse_net_options,
    src/additionally.c:3858-3952). Training-only keys are read purely so that
    (a) missing loud keys print ``Using default`` and (b) present keys don't
    later print ``Unused field`` — their values don't drive inference."""
    batch = s.find_int("batch", 1, quiet=False)
    s.find_float("learning_rate", 0.001, quiet=False)
    s.find_float("momentum", 0.9, quiet=False)
    s.find_float("decay", 0.0001, quiet=False)
    subdivs = s.find_int("subdivisions", 1, quiet=False)
    time_steps = s.find_int("time_steps", 1)
    batch = (batch // subdivs) * time_steps
    calib = s.find_str("input_calibration", None)
    calibration = tuple(_parse_float_list(calib)) if calib else ()
    if s.find_int("adam", 0):
        s.find_float("B1", 0.9, quiet=False)
        s.find_float("B2", 0.999, quiet=False)
        s.find_float("eps", 0.000001, quiet=False)
    h = s.find_int("height", 0)
    w = s.find_int("width", 0)
    c = s.find_int("channels", 0)
    inputs = s.find_int("inputs", h * w * c)
    s.find_int("max_crop", w * 2)
    s.find_int("min_crop", w)
    for k, d in (("angle", 0.0), ("aspect", 1.0), ("saturation", 1.0),
                 ("exposure", 1.0), ("hue", 0.0)):
        s.find_float(k, d)
    if not inputs and not (h and w and c):
        raise ValueError("No input parameters supplied")
    policy = s.find_str("policy", "constant", quiet=False)
    if policy not in ("random", "poly", "constant", "step", "exp", "sigmoid",
                      "steps"):
        import sys
        print(f"Couldn't find policy {policy}, going with constant",
              file=sys.stderr)
        policy = "constant"
    s.find_int("burn_in", 0)
    if policy == "step":
        s.find_int("step", 1, quiet=False)
        s.find_float("scale", 1.0, quiet=False)
    elif policy == "steps":
        steps = s.find("steps")
        scales = s.find("scales")
        if steps is None or scales is None:
            raise ValueError("STEPS policy must have steps and scales in cfg file")
    elif policy == "exp":
        s.find_float("gamma", 1.0, quiet=False)
    elif policy == "sigmoid":
        s.find_float("gamma", 1.0, quiet=False)
        s.find_int("step", 1, quiet=False)
    elif policy in ("poly", "random"):
        s.find_float("power", 1.0, quiet=False)
    s.find_int("max_batches", 0, quiet=False)
    return NetSpec(batch=batch, w=w, h=h, c=c, inputs=inputs,
                   subdivisions=subdivs, input_calibration=calibration)


def _resolve_aux_path(path, cfg_path):
    """Reference passes cfg-referenced aux paths (tree=, map=) verbatim to fopen
    (src/additionally.c:3601-3604); we also try next to the cfg for convenience."""
    import os
    if path and not os.path.exists(path):
        cand = os.path.join(os.path.dirname(os.path.abspath(cfg_path)), path)
        if os.path.exists(cand):
            return cand
    return path


def _load_tree(tree_file, cfg_path):
    if not tree_file:
        return None
    from .tree import read_tree
    return read_tree(_resolve_aux_path(tree_file, cfg_path))


def _load_map(map_file, cfg_path):
    """[region]/[yolo] ``map=`` class-index file (reference: read_map at
    src/additionally.c:1649, parsed at :3603-3604 and :3662-3663)."""
    if not map_file:
        return None
    from .tree import read_map
    return tuple(read_map(_resolve_aux_path(map_file, cfg_path)))


def _conv_quant_eligible(index: int, activation: str, stride: int, size: int,
                         quantized: bool) -> bool:
    # reference: src/additionally.c:3558-3559
    if index == 0 or activation == "linear" or (index > 1 and stride > 1) or size == 1:
        return False
    return quantized


# [yolo] keys of AlexeyAB/darknet (parse_yolo, src/parser.c there) that only
# its training reads; yolov4.cfg sets them, and they are accepted quietly
_YOLO_TRAINING_KEYS = ("iou_thresh", "iou_normalizer", "iou_loss",
                       "cls_normalizer", "obj_normalizer", "max_delta",
                       "beta_nms")


def _yolo_v4_options(s: Section, index: int) -> float:
    """The [yolo] options AlexeyAB/darknet adds (its parse_yolo): returns
    ``scale_x_y`` (default 1). ``nms_kind`` may be its default or
    ``greedynms``, whose suppression is do_nms_sort's (IoU above the
    threshold zeroes the class); ``diounms`` and ``cornersnms`` suppress by
    other measures and are refused, as is ``new_coords=1``, which decodes
    the boxes without the logistic."""
    nms_kind = s.find_str("nms_kind", "default")
    if nms_kind not in ("default", "greedynms"):
        raise ValueError(f"[yolo] layer {index}: nms_kind={nms_kind} is not "
                         "supported (the port's NMS is greedynms, darknet's "
                         "do_nms_sort)")
    if s.find_int("new_coords", 0):
        raise ValueError(f"[yolo] layer {index}: new_coords=1 (the scaled "
                         "yolov4 box decode) is not supported")
    for k in _YOLO_TRAINING_KEYS:
        s.find(k)
    return s.find_float("scale_x_y", 1.0)


def parse_network_cfg(path: str, batch: int = 0, quantized: bool = False,
                      echo_table: bool = False) -> ModelSpec:
    """Parse a darknet cfg into a ModelSpec.

    ``quantized`` mirrors the reference's ``-quantized`` flag: it seeds the per-conv
    INT8-eligibility flags (GPU rules). The CPU INT8 dispatch rule (every conv except
    index 0 / LINEAR) is applied at execution time, not here.

    ``echo_table``: print the reference's construction-time stderr layer table,
    INTERLEAVED with the option-default prints exactly as the reference emits it
    (header after [net] options, ``"%5d "`` index prefix before each section
    parse, row body at the ``make_*_layer`` call point — so loud option reads
    that the reference performs after ``make`` print after the row, e.g. a
    yolo section's ``truth_thresh: Using default``; additionally.c:3986-3989).
    Off by default so library parses stay silent; the CLI apps turn it on.
    """
    sections = read_cfg_sections(path)
    if not sections:
        raise ValueError(f"Config file {path} has no sections")
    if section_layer_type(sections[0].type) != "net":
        raise ValueError("First section must be [net] or [network]")

    net = _parse_net(sections[0])
    if batch > 0:
        net = dataclasses.replace(net, batch=batch)

    def echo(text, end="\n"):
        if echo_table:
            import sys as _sys
            print(text, end=end, file=_sys.stderr)

    echo("layer     filters    size              input                output")

    w, h, c = net.w, net.h, net.c
    inputs = net.inputs
    quant_state = quantized  # mutable copy of params.quantized

    layers: list[LayerSpec] = []
    body = sections[1:]
    for count, s in enumerate(body):
        lt = section_layer_type(s.type)
        common = dict(index=count, w=w, h=h, c=c)
        echo(f"{count:5d} ", end="")   # reference: fprintf("%5d ", count), :3988

        if lt == "convolutional":
            # yolo-lookahead permanently disables eligibility for this and later convs
            # (reference: src/additionally.c:3996-4004)
            if count + 2 < len(body) and \
                    section_layer_type(body[count + 2].type) == "yolo":
                quant_state = False

            n = s.find_int("filters", 1, quiet=False)
            size = s.find_int("size", 1, quiet=False)
            stride = s.find_int("stride", 1, quiet=False)
            pad_flag = s.find_int("pad", 0)
            padding = s.find_int("padding", 0)
            if pad_flag:
                padding = size // 2
            activation = get_activation(s.find_str("activation", "logistic",
                                                   quiet=False))
            s.find_float("dot", 0.0)  # accepted, training-only (additionally.c:3562)
            if not (h and w and c):
                raise ValueError("Layer before convolutional layer must output image.")
            bn = bool(s.find_int("batch_normalize", 0))
            out_h = (h + 2 * padding - size) // stride + 1
            out_w = (w + 2 * padding - size) // stride + 1
            layer = ConvSpec(
                **common, out_w=out_w, out_h=out_h, out_c=n,
                n=n, size=size, stride=stride, pad=padding,
                activation=activation, batch_normalize=bn,
                binary=bool(s.find_int("binary", 0)),
                xnor=bool(s.find_int("xnor", 0)),
                bin_output=bool(s.find_int("bin_output", 0)),
                quantized=_conv_quant_eligible(count, activation, stride, size,
                                               quant_state),
                flipped=s.find_int("flipped", 0),
                # honored by weights.load_weights/save_weights
                # (reference: src/additionally.c:3463,3522,4036-4037)
                dontload=bool(s.find_int("dontload", 0)),
                dontloadscales=bool(s.find_int("dontloadscales", 0)),
            )
            echo(_row_text(layer))

        elif lt == "maxpool":
            stride = s.find_int("stride", 1, quiet=False)
            size = s.find_int("size", stride, quiet=False)
            padding = s.find_int("padding", size - 1)
            if not (h and w and c):
                raise ValueError("Layer before maxpool layer must output image.")
            out_w = (w + padding - size) // stride + 1
            out_h = (h + padding - size) // stride + 1
            layer = MaxpoolSpec(**common, out_w=out_w, out_h=out_h, out_c=c,
                                size=size, stride=stride, pad=padding)
            echo(_row_text(layer))

        elif lt == "route":
            lstr = s.find("layers")
            if lstr is None:
                raise ValueError("Route Layer must specify input layers")
            idxs = []
            for v in _parse_int_list(lstr):
                idxs.append(v if v >= 0 else count + v)
            input_sizes = tuple(layers[i].outputs for i in idxs)
            first = layers[idxs[0]]
            out_w, out_h, out_c = first.out_w, first.out_h, first.out_c
            for i in idxs[1:]:
                nxt = layers[i]
                if nxt.out_w == first.out_w and nxt.out_h == first.out_h:
                    out_c += nxt.out_c
                else:
                    out_w = out_h = out_c = 0
            layer = RouteSpec(**common, out_w=out_w, out_h=out_h, out_c=out_c,
                              layers=tuple(idxs), input_sizes=input_sizes)
            echo(_row_text(layer))

        elif lt == "reorg":
            stride = s.find_int("stride", 1, quiet=False)
            reverse = bool(s.find_int("reverse", 0))
            if not (h and w and c):
                raise ValueError("Layer before reorg layer must output image.")
            if reverse:
                out_w, out_h, out_c = w * stride, h * stride, c // (stride * stride)
            else:
                out_w, out_h, out_c = w // stride, h // stride, c * (stride * stride)
            layer = ReorgSpec(**common, out_w=out_w, out_h=out_h, out_c=out_c,
                              stride=stride, reverse=reverse)
            echo(_row_text(layer))

        elif lt == "upsample":
            stride = s.find_int("stride", 2, quiet=False)
            scale = s.find_float("scale", 1.0)
            layer = UpsampleSpec(**common, out_w=w * stride, out_h=h * stride,
                                 out_c=c, stride=stride, scale=scale)
            echo(_row_text(layer))

        elif lt == "shortcut":
            from_str = s.find("from")
            fidx = int(from_str)
            if fidx < 0:
                fidx = count + fidx
            echo(f"Shortcut Layer: {fidx}")  # make_shortcut_layer, :2375
            activation = get_activation(s.find_str("activation", "linear",
                                                   quiet=False))
            # out dims = input dims (reference: make_shortcut_layer)
            layer = ShortcutSpec(**common, out_w=w, out_h=h, out_c=c,
                                 from_index=fidx, activation=activation)

        elif lt == "yolo":
            classes = s.find_int("classes", 20, quiet=False)
            total = s.find_int("num", 1, quiet=False)
            mask_str = s.find_str("mask", None)
            mask = tuple(_parse_int_list(mask_str)) if mask_str else None
            num = len(mask) if mask else total
            if mask is None:
                mask = tuple(range(num))
            max_boxes = s.find_int("max", 90)
            echo("yolo")                     # make_yolo_layer, :2542
            class_map = _load_map(s.find_str("map", None), path)
            jitter = s.find_float("jitter", 0.2, quiet=False)
            focal_loss = s.find_int("focal_loss", 0)
            ignore_thresh = s.find_float("ignore_thresh", 0.5, quiet=False)
            truth_thresh = s.find_float("truth_thresh", 1.0, quiet=False)
            rand = s.find_int("random", 0)
            anchors_str = s.find_str("anchors", None)
            anchors = [0.5] * (2 * total)
            if anchors_str:
                vals = _parse_float_list(anchors_str)
                for i, v in enumerate(vals[: 2 * total]):
                    anchors[i] = v
            scale_x_y = _yolo_v4_options(s, count)
            out_c = num * (classes + 4 + 1)
            layer = YoloSpec(**common, out_w=w, out_h=h, out_c=out_c,
                             n=num, total=total, mask=mask, classes=classes,
                             anchors=tuple(anchors),
                             max_boxes=max_boxes,
                             jitter=jitter,
                             ignore_thresh=ignore_thresh,
                             truth_thresh=truth_thresh,
                             random=rand,
                             focal_loss=focal_loss,
                             class_map=class_map,
                             scale_x_y=scale_x_y)
            if layer.outputs != inputs:
                raise ValueError(
                    "filters= in the [convolutional]-layer doesn't correspond to "
                    "classes= or mask= in [yolo]-layer")

        elif lt == "region":
            # lookup order/loudness mirrors parse_region (src/additionally.c:3573-3620)
            coords = s.find_int("coords", 4, quiet=False)
            classes = s.find_int("classes", 20, quiet=False)
            num = s.find_int("num", 1, quiet=False)
            echo("detection")                # make_region_layer, :2592
            log_ = s.find_int("log", 0)
            sqrt_ = s.find_int("sqrt", 0)
            softmax = bool(s.find_int("softmax", 0, quiet=False))
            max_boxes = s.find_int("max", 30)
            jitter = s.find_float("jitter", 0.2, quiet=False)
            rescore = s.find_int("rescore", 0)
            thresh = s.find_float("thresh", 0.5, quiet=False)
            classfix = s.find_int("classfix", 0)
            absolute = s.find_int("absolute", 0)
            rand = s.find_int("random", 0)
            coord_scale = s.find_float("coord_scale", 1.0, quiet=False)
            object_scale = s.find_float("object_scale", 1.0, quiet=False)
            noobject_scale = s.find_float("noobject_scale", 1.0, quiet=False)
            class_scale = s.find_float("class_scale", 1.0, quiet=False)
            bias_match = s.find_int("bias_match", 0)
            tree = _load_tree(s.find_str("tree", None), path)
            class_map = _load_map(s.find_str("map", None), path)
            anchors_str = s.find_str("anchors", None)
            anchors = [0.5] * (2 * num)
            if anchors_str:
                vals = _parse_float_list(anchors_str)
                for i, v in enumerate(vals[: 2 * num]):
                    anchors[i] = v
            out_c = num * (classes + coords + 1)
            layer = RegionSpec(**common, out_w=w, out_h=h, out_c=out_c,
                               n=num, classes=classes, coords=coords,
                               anchors=tuple(anchors),
                               softmax=softmax,
                               max_boxes=max_boxes,
                               thresh=thresh,
                               classfix=classfix,
                               jitter=jitter,
                               rescore=rescore,
                               bias_match=bias_match,
                               softmax_tree=tree,
                               class_map=class_map,
                               log=log_, sqrt=sqrt_, absolute=absolute,
                               random=rand,
                               coord_scale=coord_scale,
                               object_scale=object_scale,
                               noobject_scale=noobject_scale,
                               class_scale=class_scale)
            if layer.outputs != inputs:
                raise ValueError("region layer outputs != inputs")

        elif lt == "softmax":
            groups = s.find_int("groups", 1)
            echo(f"softmax                                        {inputs:4d}")
            # reference make_softmax_layer keeps inputs==outputs, 1D
            layer = SoftmaxSpec(index=count, w=inputs, h=1, c=1,
                                out_w=inputs, out_h=1, out_c=1,
                                groups=groups,
                                temperature=s.find_float("temperature", 1.0),
                                softmax_tree=_load_tree(s.find_str("tree", None),
                                                        path))

        else:
            raise ValueError(f"Type not recognized: {s.type}")

        s.find("dontload")        # accepted like the reference (parse tail reads
        s.find("dontloadscales")  # them for every layer, src/additionally.c:4022-4023)
        for k in s.unused_keys():
            # reference: option_unused prints "Unused field" (src/additionally.c:3330)
            import sys as _sys
            print(f"Unused field: '{k} = {s.options[k]}'", file=_sys.stderr)
        layers.append(layer)
        # chain dims (reference: parse_network_cfg tail, src/additionally.c:4030-4035)
        w, h, c = layer.out_w, layer.out_h, layer.out_c
        inputs = layer.outputs

    return ModelSpec(net=net, layers=tuple(layers))


# ---------------------------------------------------------------------------
# Layer-table pretty printer (parity with reference stderr table)
# ---------------------------------------------------------------------------

def _row_text(l) -> str:
    """The exact stderr row body the reference's make_*_layer prints
    (src/additionally.c: conv :2904-2908, max :2651, route :2453-2466,
    reorg :2420, upsample :2365-2366, shortcut :2375, yolo :2542,
    region :2592, softmax :2302)."""
    if isinstance(l, ConvSpec):
        kind = ("convXB" if l.xnor and l.bin_output
                else "convX " if l.xnor else "conv  ")
        return (f"{kind}{l.n:5d} {l.size:2d} x{l.size:2d} /{l.stride:2d}  "
                f"{l.w:4d} x{l.h:4d} x{l.c:4d}   ->  "
                f"{l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d} {l.bflops:5.3f} BF")
    if isinstance(l, MaxpoolSpec):
        return (f"max          {l.size} x {l.size} / {l.stride}  "
                f"{l.w:4d} x{l.h:4d} x{l.c:4d}   ->  "
                f"{l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}")
    if isinstance(l, RouteSpec):
        return "route " + "".join(f" {i}" for i in l.layers)
    if isinstance(l, ReorgSpec):
        return (f"reorg              /{l.stride:2d}  "
                f"{l.w:4d} x{l.h:4d} x{l.c:4d}   ->  "
                f"{l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}")
    if isinstance(l, UpsampleSpec):
        return (f"upsample           {l.stride:2d}x  "
                f"{l.w:4d} x{l.h:4d} x{l.c:4d}   ->  "
                f"{l.out_w:4d} x{l.out_h:4d} x{l.out_c:4d}")
    if isinstance(l, ShortcutSpec):
        return f"Shortcut Layer: {l.from_index}"
    if isinstance(l, YoloSpec):
        return "yolo"
    if isinstance(l, RegionSpec):
        return "detection"
    if isinstance(l, SoftmaxSpec):
        return f"softmax                                        {l.w:4d}"
    return type(l).__name__


def format_layer_table(spec: ModelSpec) -> str:
    """Recreate the reference's construction-time stderr table
    (reference: make_* fprintf lines, src/additionally.c:2296-2910)."""
    lines = ["layer     filters    size              input                output"]
    for l in spec.layers:
        lines.append(f"{l.index:5d} " + _row_text(l))
    return "\n".join(lines)
