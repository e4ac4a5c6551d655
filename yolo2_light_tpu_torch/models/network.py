"""Network forward: ModelSpec -> ``forward(params, x)`` in PyTorch.

Counterpart of ``yolo2_light_tpu/models/network.py``. PyTorch runs eagerly,
so the forward is a Python loop over the static spec that calls one op per
layer; the int8 convs launch the hand-written kernel of ``ops/int8_conv``.

Ported modes:

* ``fp32``: dense convs in full float32 (TF32 off), or in bfloat16 with
  ``compute_dtype=torch.bfloat16`` (``-bf16``; ``layers.conv2d_fp32``);
* ``int8`` with ``int8_policy="cpu"``: every conv except index 0 and the
  LINEAR-activation convs runs the int8 path (reference dispatch:
  src/yolov2_forward_network_quantized.c:1036-1037), with the requant
  epilogue; with ``int8_policy="gpu"``: the convs with the cfg's
  ``quantized`` eligibility flag (reference: parse_convolutional +
  yolo-lookahead, src/additionally.c:3558,3996), with the reference's cuDNN
  INT8x4 epilogue. ``int8_impl="fused"`` (``cpu`` policy only, as in the JAX
  package) runs each darknet53 residual block (1x1 conv, 3x3 conv,
  shortcut) as one launch of the kernel of ``ops/fused_res`` and the other
  int8 convs on ``ops/int8_conv``: bit-identical to the unfused path.
* ``turbo`` (a TPU-native extension of the JAX package, not a reference
  semantics): ``True``/"bf16" materializes the activations between layers
  as bfloat16 (every conv's math stays float32; the int8 kernel reads and
  stores bfloat16 itself), "int8" (int8 mode only) the residual trunk as
  int8 at the nearest downstream int8 conv's input multiplier
  (``_trunk_targets``). Heads run in float32 in every mode.
* XNOR convs (``xnor=1``, outside the int8 set) in either mode, on the engine
  ``xnor_impl`` names: ``int8`` the dense +-1 conv (``layers.conv2d_xnor``),
  ``pallas`` the popcount kernel and ``pallas_mxu`` the bit-packed int8
  kernel of ``ops/xnor_gemm`` (both only where stride == 1 and pad == 1, the
  reference's bit path; every other XNOR conv takes the dense engine), and
  ``auto`` a per-layer pick between ``pallas_mxu`` and ``int8`` on the GEMM
  M = batch*oh*ow. All engines are bit-identical.
* ``int8`` with ``int8_policy="cpu_old"``: the reference's legacy
  all-int8 chain (``build_forward_int8_old``): int8 activations between the
  layers, each int8 conv one launch of the int8 kernel's "old" epilogue,
  storing the float and/or int8 output its consumers read.

``capture_conv_inputs`` returns the input of every conv in
``aux["conv_inputs"]`` (``detector calibrate``'s statistics), with the
fused engine off, as in the JAX package.

The int8 chain (``int8_chain``, on by default as in the JAX ``Predictor``):
the JAX package quantizes a layer's output for its unique downstream int8
conv in the producer (``_int8_chain_targets``) and carries (int8 tensor,
target conv) pairs through maxpool, route, reorg and scale-1 upsample. That
quantize equals the one the int8 kernel makes in its loader, so the port
carries such a pair without its tensor (the target conv quantizes its
float input itself) and makes the tensor only where it is more than that:
under ``turbo="int8"``, whose trunk quantization feeds the target conv the
producer's q, which its dequantized view need not give back.

The region head's softmax tree (YOLO9000) and ``[softmax]`` layers (plain,
grouped or over the tree's groups) run as in the JAX package; a layer type
its forward does not run raises ``NotImplementedError`` here too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..cfg import (ConvSpec, MaxpoolSpec, ModelSpec, RegionSpec, ReorgSpec,
                   RouteSpec, ShortcutSpec, SoftmaxSpec, UpsampleSpec,
                   YoloSpec)
from ..ops import bf16_conv, fused_res, int8_conv, xnor_gemm
from ..params import params_to_torch
from ..tree import softmax_groups
from . import layers as L

# "xla", "pallas" and "fused" name the JAX package's engines; on the port
# "xla" and "pallas" run the int8 conv kernel behind every int8 conv, and
# "fused" runs the residual blocks on the fused kernel and the other int8
# convs on the int8 conv kernel. "plain" runs every kernel's plain PyTorch
# version instead (the int8 ones, the XNOR engine's and -bf16's float conv),
# on any device: the reference the kernel paths are checked against;
# "fused_plain" does so with the fused engine's blocks (which under
# turbo="int8" compute another function than the unfused path: a run's
# interior trunk stays float32).
INT8_IMPLS = ("xla", "pallas", "fused", "plain", "fused_plain")
XNOR_IMPLS = ("int8", "pallas", "pallas_mxu", "auto")


class HeadOutput(NamedTuple):
    """Post-activation output of a detection head, cell-major.

    ``data``: [B, H, W, n, entries] where entries = 4 coords + 1 obj + classes.
    """
    index: int
    kind: str          # "yolo" | "region"
    data: torch.Tensor


def _int8_layer_set(spec: ModelSpec, policy: str) -> set:
    """Indices of the convs that run the int8 path under ``policy``
    ("cpu_old" runs the same convs as "cpu" in its legacy chain)."""
    out = set()
    for l in spec.layers:
        if not isinstance(l, ConvSpec):
            continue
        if policy in ("cpu", "cpu_old"):
            if l.index >= 1 and l.activation != "linear":
                out.add(l.index)
        elif policy == "gpu":
            if l.quantized:
                out.add(l.index)
        else:
            raise ValueError(f"unknown int8 policy {policy!r}")
    return out


def _consumers(spec: ModelSpec) -> dict:
    """layer index -> indices of layers reading its output (routes read their
    sources; shortcuts read from_index and the preceding layer; every other
    non-first layer reads its predecessor)."""
    consumers: dict[int, list] = {i: [] for i in range(spec.n)}
    for l in spec.layers:
        if isinstance(l, RouteSpec):
            for j in l.layers:
                consumers[j].append(l.index)
        elif isinstance(l, ShortcutSpec):
            consumers[l.from_index].append(l.index)
            consumers[l.index - 1].append(l.index)
        elif l.index > 0:
            consumers[l.index - 1].append(l.index)
    return consumers


def _int8_chain_targets(spec: ModelSpec, int8_set: set) -> dict:
    """For each layer index, the index of the unique int8 conv reachable from its
    output through quantization-commuting ops (maxpool/route/reorg/upsample-scale-1),
    or None when absent/ambiguous. Quantization (monotone trunc+clamp) commutes
    exactly with max/concat/permute/repeat, so a producer can emit pre-quantized
    int8 activations for its downstream int8 conv; static analysis keeps only the
    unique-consumer case (a shared output feeding two int8 convs could have two
    different input multipliers)."""
    consumers = _consumers(spec)
    targets: dict[int, object] = {}

    def target_of(i: int):
        """int8-conv consumer index wanted from layer i's OUTPUT (memoized)."""
        if i in targets:
            return targets[i]
        wanted = set()
        for c in consumers.get(i, []):
            lc = spec.layers[c]
            if isinstance(lc, ConvSpec):
                if c in int8_set:
                    wanted.add(c)
            elif isinstance(lc, (MaxpoolSpec, RouteSpec, ReorgSpec)):
                t = target_of(c)
                if t is not None:
                    wanted.add(t)
            elif isinstance(lc, UpsampleSpec) and lc.scale == 1.0:
                t = target_of(c)
                if t is not None:
                    wanted.add(t)
            # shortcut/heads need float only
        targets[i] = wanted.pop() if len(wanted) == 1 else None
        return targets[i]

    for i in range(spec.n - 1, -1, -1):
        target_of(i)
    return targets


def _trunk_targets(spec: ModelSpec, int8_set: set) -> dict:
    """int8-residual-trunk scale analysis (``turbo="int8"``): for each
    layer index, the NEAREST downstream int8 conv whose
    ``input_quant_multipler`` scales this layer's materialized activation —
    reachable through maxpool/route/reorg/upsample AND (unlike the bit-exact
    chain analysis) shortcut layers, since the residual trunk is exactly the
    tensors shortcuts keep alive. Multi-consumer ambiguity resolves to the
    smallest target index (nearest in program order): the scale choice only
    bounds the residual materialization error, it does not need the
    uniqueness producer-side emission does. Reference precedent for an
    int8-chained trunk: the old fully-int8 pipeline,
    src/yolov2_forward_network_quantized.c:636-801."""
    consumers = _consumers(spec)
    targets: dict[int, object] = {}

    def target_of(i: int):
        if i in targets:
            return targets[i]
        targets[i] = None   # guard (consumers only point forward, but be safe)
        wanted = set()
        for c in consumers.get(i, []):
            lc = spec.layers[c]
            if isinstance(lc, ConvSpec):
                if c in int8_set:
                    wanted.add(c)
            elif (isinstance(lc, (MaxpoolSpec, RouteSpec, ReorgSpec,
                                  ShortcutSpec))
                  or (isinstance(lc, UpsampleSpec) and lc.scale == 1.0)):
                # non-unit upsample scale multiplies values AFTER this
                # producer, so the consumer's calibrated multiplier does not
                # apply to the pre-scale tensor — stop, keep float (same
                # reasoning as the chain analysis above)
                t = target_of(c)
                if t is not None:
                    wanted.add(t)
        targets[i] = min(wanted) if wanted else None
        return targets[i]

    for i in range(spec.n - 1, -1, -1):
        target_of(i)
    return targets


def resolve_residual_dtype(turbo):
    """Map the ``-turbo`` family flag to the residual dtype:
    False -> None, True/"bf16" -> torch.bfloat16, "int8" -> "int8"."""
    if not turbo:
        return None
    if turbo is True or turbo == "bf16":
        return torch.bfloat16
    if turbo == "int8":
        return "int8"
    raise ValueError(f"unknown turbo mode {turbo!r} "
                     "(expected False, True, 'bf16', or 'int8')")


def _quantize_i8(x, mult: float):
    """``clamp(trunc(x * mult), +-127)`` in float32 (a bfloat16 ``x`` upcast
    first, as JAX promotes it against the float32 multiplier)."""
    return L.quantize_i8(x.to(torch.float32), mult)


def _recip(m: float) -> float:
    """float32 ``1 / m`` (JAX's ``1.0 / m`` of a float32 scalar), as a
    Python float holding that float32 value."""
    return float(np.float32(1.0) / np.float32(m))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to "
                               "yolo2_light_tpu_torch")


def _tree_groups(l):
    """The softmax tree's group sizes of a region or softmax layer, or None
    (the JAX forward's ``softmax_groups`` spans, sizes only)."""
    if l.softmax_tree is None:
        return None
    return [gs for _, gs in softmax_groups(l.softmax_tree)]


def _check_ported(spec: ModelSpec, mode: str, int8_policy: str,
                  int8_impl: str, xnor_impl: str, compute_dtype,
                  turbo) -> set:
    """Raise on anything this port does not run yet, and on the JAX
    package's mode gates; returns the int8 set."""
    if mode not in ("fp32", "int8"):
        raise ValueError(f"unknown mode {mode!r} (expected fp32 or int8)")
    if int8_impl not in INT8_IMPLS:
        raise ValueError(f"unknown int8_impl {int8_impl!r} "
                         f"(expected one of {', '.join(INT8_IMPLS)})")
    if xnor_impl not in XNOR_IMPLS:
        raise ValueError(f"unknown xnor_impl {xnor_impl!r} "
                         "(expected int8, pallas, pallas_mxu, or auto)")
    if int8_policy not in ("cpu", "gpu", "cpu_old"):
        raise ValueError(f"unknown int8 policy {int8_policy!r}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {compute_dtype} (expected float32 "
                         "or bfloat16)")
    if resolve_residual_dtype(turbo) == "int8" and mode != "int8":
        raise ValueError(
            "turbo='int8' (turbo_int8) requires int8 mode: the trunk scales "
            "come from the conv input_quant_multipler values")
    int8_set = _int8_layer_set(spec, int8_policy) if mode == "int8" else set()
    if mode == "int8" and int8_policy == "cpu_old":
        # the old chain runs no XNOR, fused or turbo path and reads no
        # softmax tree, as in the JAX package; other layer types raise there
        for l in spec.layers:
            if not isinstance(l, _OLD_LAYERS):
                raise NotImplementedError(
                    f"{type(l).__name__} is not supported by the reference's "
                    "old INT8 pipeline (src/yolov2_forward_network_quantized."
                    "c:1121-1133 comments it out)")
    return int8_set


def _fused_stage_runs(spec: ModelSpec, int8_set: set) -> dict:
    """Maximal runs of darknet53 residual blocks

        conv1x1(leaky, int8) -> conv3x3(leaky, int8) -> shortcut(linear, from=-3)

    whose interior outputs feed nothing outside the run, as
    {start_conv_index: [(i_conv1, i_conv2, i_shortcut), ...]}: the JAX
    package's ``_fused_stage_runs`` without its two TPU-only limits. It
    splits runs to fit a VMEM budget and drops trunks whose C is not a
    multiple of 128 (DMA lane tiling); on the card every block is one launch
    whatever the run's length or width, so a run is only a grouping, and
    every matching block fuses."""
    consumers = _consumers(spec)

    def block_at(i):
        """(i, i+1, i+2) is a fusible residual block starting at conv i."""
        if i + 2 >= spec.n:
            return None
        l1, l2, ls = spec.layers[i], spec.layers[i + 1], spec.layers[i + 2]
        if not (isinstance(l1, ConvSpec) and l1.size == 1 and l1.stride == 1
                and l1.pad == 0 and l1.activation == "leaky" and i in int8_set
                and not l1.xnor):
            return None
        if not (isinstance(l2, ConvSpec) and l2.size == 3 and l2.stride == 1
                and l2.pad == 1 and l2.activation == "leaky"
                and (i + 1) in int8_set and not l2.xnor
                and l2.n == l1.c):   # 3x3 output must match the trunk width
            return None
        if not (isinstance(ls, ShortcutSpec) and ls.from_index == i - 1
                and ls.activation == "linear"):
            return None
        # interior conv outputs must feed only the block itself
        if consumers[i] != [i + 1] or consumers[i + 1] != [i + 2]:
            return None
        return (i, i + 1, i + 2)

    runs: dict[int, list] = {}
    i = 1
    while i + 2 < spec.n:
        blk = block_at(i)
        if blk is None:
            i += 1
            continue
        run = [blk]
        # extend: the previous shortcut's output may feed only the next block
        while True:
            e = run[-1][2]
            nxt = block_at(e + 1)
            if nxt is None or sorted(consumers[e]) != [e + 1, e + 3]:
                break
            run.append(nxt)
        runs[run[0][0]] = run
        i = run[-1][2] + 1
    return runs


def _bit_path(l: ConvSpec) -> bool:
    """The reference takes its XNOR bit path (0-bit, i.e. -1, borders) only
    at stride 1 and pad 1; the bit engines run only there."""
    return l.stride == 1 and l.pad == 1


def _xnor_engine(l: ConvSpec, xnor_impl: str, batch: int) -> str:
    """The engine XNOR conv ``l`` runs at ``batch``: "int8" (the dense +-1
    conv), "pallas" (K3) or "pallas_mxu" (K4). All are bit-identical, so
    "auto" is a speed pick on the GEMM M = batch*oh*ow: the bit-packed
    kernel where M is small, the dense conv above
    (``ops/xnor_gemm.auto_prefers_mxu``)."""
    if xnor_impl == "auto":
        xnor_impl = ("pallas_mxu" if xnor_gemm.auto_prefers_mxu(
            batch * l.out_h * l.out_w) else "int8")
    return xnor_impl if _bit_path(l) else "int8"


def _dropped_fields(l, int8_set: set, xnor_impl: str,
                    old: bool = False) -> frozenset:
    """Converted params a layer's path does not read: an int8 conv keeps its
    int8 weights (and ignores xnor=1), a float conv its float weights, an
    XNOR conv the weights of the engines ``xnor_impl`` may give it. Only the
    ``cpu_old`` chain (``old``) reads ``biases_quant``, in its int8 convs,
    which read no float biases; it reads no XNOR field."""
    xnor_fields = {"sign_weights", "packed_weights", "mean_arr"}
    if old:
        if l.index in int8_set:
            return frozenset({"weights", "biases"} | xnor_fields)
        return frozenset({"weights_int8", "biases_quant"} | xnor_fields)
    if l.index in int8_set:
        return frozenset({"weights", "biases_quant"} | xnor_fields)
    if not (isinstance(l, ConvSpec) and l.xnor):
        return frozenset({"weights_int8", "biases_quant"})
    keep = {"mean_arr"}
    if xnor_impl in ("int8", "auto") or not _bit_path(l):
        keep.add("sign_weights")
    if xnor_impl != "int8" and _bit_path(l):
        keep.add("packed_weights")
    return frozenset({"weights", "weights_int8", "biases_quant"}
                     | (xnor_fields - keep))


def _block_args(p1: dict, p2: dict) -> dict:
    """One residual block's convs' params as ``fused_res_block`` arguments."""
    return dict(w1=p1["weights_int8"], b1=p1["biases"],
                m1=p1["input_quant_multipler"], alpha1=p1["alpha"],
                w2=p2["weights_int8"], b2=p2["biases"],
                m2=p2["input_quant_multipler"], alpha2=p2["alpha"])


def build_forward(spec: ModelSpec, mode: str = "fp32", *,
                  int8_policy: str = "cpu", int8_impl: str = "xla",
                  xnor_impl: str = "int8", compute_dtype=torch.float32,
                  turbo=False, int8_chain: bool = True,
                  capture_conv_inputs: bool = False, layer_hook=None,
                  layer_range=None, carry_out=None, int8_targets=None):
    """Return ``forward(params, x) -> (heads, aux)``.

    ``x``: [B, H, W, C] float32, NHWC, values in [0,1]. ``params``: the
    per-layer list of ``params.params_to_torch``. ``heads`` is a tuple of
    HeadOutput (float32 in every mode); ``aux["final"]`` is the last layer's
    output, and with ``capture_conv_inputs`` ``aux["conv_inputs"]`` the
    input of every conv in order. The modes and the int8 chain are in the
    module docstring. ``layer_hook(i)``, where given, is called after each
    layer i has been issued (``utils/profiling.profile_layers`` records its
    per-layer times there).

    ``layer_range=(start, stop)`` (pipeline stages, ``parallel/pp.py``, and
    the runs between collectives of ``parallel/mesh.py``): run only
    ``spec.layers[start:stop]``. ``x`` is then the previous range's running
    activation and ``forward`` takes a third argument ``carried``, a dict
    {layer index: output} of the earlier outputs that routes and shortcuts
    in the range read; ``carry_out`` (a set of indices) names the outputs
    returned in ``aux["outputs"]`` for later ranges. As in the JAX package,
    an int8 chain or ``turbo="int8"`` trunk target outside the range is
    dropped (the tensor crosses as float: the consumer's own quantize,
    bit-identical to the producer's), and a fused residual run that
    straddles ``stop`` runs on the int8 conv kernel. ``cpu_old``'s legacy
    chain takes no range (its JAX counterpart takes none either).

    ``int8_targets=(start, stop)`` (the runs between the collectives of
    ``parallel/mesh.py``, whose positions hold the params of every layer in
    that wider range): the chain and trunk targets in it are kept, and the
    int8 state crosses the run's ends, so that the runs compute the wider
    range's function under ``turbo="int8"`` too: ``forward`` takes a fourth
    argument and returns ``aux["i8"]``, {"cur": the running (int8 tensor or
    None, target) pair, "outputs": {j: pair} of the route sources in
    ``carry_out``}.
    """
    int8_set = _check_ported(spec, mode, int8_policy, int8_impl, xnor_impl,
                             compute_dtype, turbo)
    plain = int8_impl in ("plain", "fused_plain")
    if mode == "int8" and int8_policy == "cpu_old":
        if layer_range is not None:
            raise ValueError(
                "the legacy int8 chain (-int8_policy cpu_old) runs as one "
                "forward: it takes no layer range (-pp stages, -tp/-sp runs)")
        return build_forward_int8_old(spec, plain=plain)
    residual_dtype = resolve_residual_dtype(turbo)
    int8_resid = residual_dtype == "int8"
    # the bfloat16 store of turbo; the int8 trunk is materialized by the
    # trunk quantize (resid_q), so it narrows no other output
    narrow = torch.bfloat16 if residual_dtype is torch.bfloat16 else None
    trunk = _trunk_targets(spec, int8_set) if int8_resid else {}
    chain = (_int8_chain_targets(spec, int8_set)
             if mode == "int8" and int8_chain else {})
    # the fused kernel implements the cpu requant only: the gpu policy keeps
    # its convs on the int8 conv kernel
    fused_runs = (_fused_stage_runs(spec, int8_set)
                  if mode == "int8" and int8_impl in ("fused", "fused_plain")
                  and int8_policy == "cpu" and not capture_conv_inputs
                  else {})
    lo, hi = (0, spec.n) if layer_range is None else layer_range
    if layer_range is not None:
        fused_runs = {st: r for st, r in fused_runs.items()
                      if st >= lo and r[-1][2] < hi}
        # a range holds only its own layers' params: a trunk or chain
        # target in a later range has none here
        tlo, thi = int8_targets or layer_range
        trunk = {i: t for i, t in trunk.items()
                 if t is not None and tlo <= t < thi}
        chain = {i: t for i, t in chain.items()
                 if t is not None and tlo <= t < thi}
    fused_skip = {idx for run in fused_runs.values()
                  for blk in run for idx in blk} - set(fused_runs)
    # outputs a route or a shortcut reads, and those a later range reads;
    # every other one is dropped once the next layer has consumed it
    readers = _consumers(spec)
    kept = {j for j, rs in readers.items()
            if any(isinstance(spec.layers[c], (RouteSpec, ShortcutSpec))
                   for c in rs)} | set(carry_out or ())
    route_srcs = {j for j, rs in readers.items()
                  if any(isinstance(spec.layers[c], RouteSpec) for c in rs)}
    L.set_fp32_precision()

    def pallas_conv(l: ConvSpec) -> bool:
        """The JAX package's ``-int8_impl pallas`` runs these convs on
        ``conv3x3_int8_tiled``, whose float32 output no turbo narrows."""
        return (int8_impl == "pallas" and int8_policy == "cpu"
                and l.size == 3 and l.stride == 1 and l.pad == 1
                and l.activation in ("leaky", "linear"))

    def forward(params, x, carried=None, i8=None):
        outputs: dict[int, torch.Tensor] = dict(carried or {})
        # idx -> (int8 tensor or None, target conv idx): the int8 chain's
        # pairs of the layers a route reads; None stands for the target's
        # quantize of the layer's float output
        i8_outputs: dict[int, tuple] = dict((i8 or {}).get("outputs", {}))
        heads: list[HeadOutput] = []
        conv_inputs: list[torch.Tensor] = []
        cur = x
        # (tensor or None, target) or None
        cur_i8 = (i8 or {}).get("cur")

        def mult(t: int) -> float:
            return params[t]["input_quant_multipler"]

        def emit_i8(i):
            """The JAX package's producer-side quantize of layer i's output
            for its chain target, carried without its tensor: the target's
            loader makes the same quantize."""
            t = chain.get(i)
            if t is None:
                return None
            i8_outputs[i] = (None, t)
            return i8_outputs[i]

        def dequant(q, t):
            # int8 * a Python float: float32 q times the float32 1/m
            return q * _recip(mult(t))

        def resid_q(i, value):
            """int8 residual-trunk materialization (turbo="int8"): value
            quantized at the nearest downstream int8 conv's multiplier.
            Returns (float32 view, (q, target) | None)."""
            t = trunk.get(i)
            if t is None:
                return value, None
            q = _quantize_i8(value, mult(t))
            return dequant(q, t), (q, t)

        def finish_conv(i, value, q=None):
            """Common conv epilogue: int8-residual materialization (``q``:
            the trunk quantize the int8 kernel stored itself) + the int8
            chain. Returns (cur, cur_i8)."""
            if not int8_resid:
                return value, emit_i8(i)
            if q is None:
                view, pair = resid_q(i, value)
            else:
                pair = (q, trunk[i])
                view = dequant(q, trunk[i])
            if pair is not None and chain.get(i) == pair[1]:
                i8_outputs[i] = pair   # q IS the consumer's quantization
                return view, pair
            return view, emit_i8(i)

        for l in spec.layers[lo:hi]:
            i = l.index
            if i in fused_runs:
                run = fused_runs[i]
                blocks = [_block_args(params[i1], params[i2])
                          for i1, i2, _ in run]
                # the fused kernel keeps a float32 trunk in and out
                cur = fused_res.run_blocks(
                    cur.to(torch.float32).contiguous(), blocks, plain=plain)
                if narrow is not None:
                    cur = cur.to(narrow)
                cur_i8 = None
                if int8_resid:
                    cur, cur_i8 = resid_q(run[-1][2], cur)
                    if cur_i8 is not None:
                        i8_outputs[run[-1][2]] = cur_i8
                # the run's interior outputs feed nothing outside it
                outputs[run[-1][2]] = cur
                continue
            if i in fused_skip:
                continue
            if isinstance(l, ConvSpec):
                p = params[i]
                if capture_conv_inputs:
                    conv_inputs.append(cur)
                # an int8-eligible conv runs the int8 path even with xnor=1,
                # as the reference's quantized forwards have no xnor branch
                if l.xnor and i not in int8_set:
                    engine = _xnor_engine(l, xnor_impl, cur.shape[0])
                    if engine == "int8":
                        cur = L.conv2d_xnor(cur, p["sign_weights"],
                                            p["mean_arr"], p["biases"],
                                            l.stride, l.pad, l.activation)
                    else:
                        cur = xnor_gemm.conv2d_xnor_bits(
                            cur, p["packed_weights"], p["mean_arr"],
                            p["biases"], c_real=l.c, stride=l.stride,
                            pad=l.pad, activation=l.activation,
                            engine=("mxu" if engine == "pallas_mxu"
                                    else "popcount"), plain=plain)
                    # XNOR outputs stay float32 under turbo, as in JAX
                    cur, cur_i8 = finish_conv(i, cur)
                elif i in int8_set:
                    xi8 = (cur_i8[0] if cur_i8 is not None and cur_i8[1] == i
                           else None)
                    t = trunk.get(i)
                    store = (dict(out_dtype=torch.int8, out_mult=mult(t))
                             if t is not None else
                             dict(out_dtype=None if pallas_conv(l)
                                  else narrow))
                    y = L.conv2d_int8(
                        cur, p["weights_int8"], p["biases"], l.stride, l.pad,
                        l.activation, p["input_quant_multipler"],
                        p["inv" if int8_policy == "gpu" else "alpha"],
                        plain=plain, semantics=int8_policy, x_int8=xi8,
                        **store)
                    cur, cur_i8 = (finish_conv(i, None, q=y) if t is not None
                                   else finish_conv(i, y))
                else:
                    bn = None
                    if "scales" in p:
                        bn = (p["scales"], p["rolling_mean"],
                              p["rolling_variance"])
                    cur = L.conv2d_fp32(cur, p["weights"], p["biases"],
                                        l.stride, l.pad, l.activation, bn=bn,
                                        compute_dtype=compute_dtype,
                                        plain=plain,
                                        weights_k32=p.get("weights_k32"))
                    if narrow is not None:
                        cur = cur.to(narrow)
                    cur, cur_i8 = finish_conv(i, cur)
            elif isinstance(l, MaxpoolSpec):
                # quantize commutes with max: pool the int8 chain directly
                # the output extent from the input's (the spec's for a
                # whole map; a row slab's under parallel/mesh.py)
                out_h, out_w = [(n + l.pad - l.size) // l.stride + 1
                                for n in cur.shape[1:3]]
                if cur_i8 is not None and chain.get(i) == cur_i8[1]:
                    if cur_i8[0] is not None:
                        cur_i8 = (L.maxpool(cur_i8[0], l.size, l.stride,
                                            l.pad, out_w, out_h),
                                  cur_i8[1])
                    i8_outputs[i] = cur_i8
                else:
                    cur_i8 = None
                cur = L.maxpool(cur, l.size, l.stride, l.pad, out_w, out_h)
            elif isinstance(l, RouteSpec):
                t = chain.get(i)
                srcs = [i8_outputs.get(j) for j in l.layers]
                if l.out_c == 0:
                    # degenerate flat concat (mismatched spatial dims):
                    # float only
                    srcs = [None]
                cur = L.route([outputs[j] for j in l.layers])
                if t is not None and all(
                        s is not None and s[1] == t for s in srcs):
                    if all(s[0] is None for s in srcs):
                        cur_i8 = (None, t)
                    else:
                        cur_i8 = (torch.cat(
                            [_quantize_i8(outputs[j], mult(t)) if s[0] is None
                             else s[0] for s, j in zip(srcs, l.layers)],
                            dim=-1), t)
                    i8_outputs[i] = cur_i8
                else:
                    cur_i8 = None
            elif isinstance(l, ReorgSpec):
                if cur_i8 is not None and chain.get(i) == cur_i8[1]:
                    if cur_i8[0] is not None:
                        cur_i8 = (L.reorg(cur_i8[0], l.stride, l.reverse),
                                  cur_i8[1])
                    i8_outputs[i] = cur_i8
                else:
                    cur_i8 = None
                cur = L.reorg(cur, l.stride, l.reverse)
            elif isinstance(l, UpsampleSpec):
                if (cur_i8 is not None and chain.get(i) == cur_i8[1]
                        and l.scale == 1.0):
                    if cur_i8[0] is not None:
                        cur_i8 = (L.upsample(cur_i8[0], l.stride, 1.0),
                                  cur_i8[1])
                    i8_outputs[i] = cur_i8
                else:
                    cur_i8 = None
                cur = L.upsample(cur, l.stride, l.scale)
            elif isinstance(l, ShortcutSpec):
                cur_i8 = None
                cur = L.shortcut(cur, outputs[l.from_index], l.activation)
                if int8_resid:
                    # turbo_int8: the shortcut output IS the residual trunk;
                    # the (q, target) pair doubles as the downstream conv's
                    # pre-quantized input
                    cur, cur_i8 = resid_q(i, cur)
                    if cur_i8 is not None:
                        i8_outputs[i] = cur_i8
            elif isinstance(l, YoloSpec):
                cur_i8 = None
                cur = cur.to(torch.float32)     # head math stays float32
                b, h, w, _ = cur.shape
                cur = L.yolo_head(cur, l.n, l.classes)
                heads.append(HeadOutput(
                    i, "yolo", cur.reshape(b, h, w, l.n, 5 + l.classes)))
            elif isinstance(l, RegionSpec):
                cur_i8 = None
                y5 = L.region_head(cur.to(torch.float32), l.n, l.classes,
                                   l.coords, l.softmax,
                                   softmax_tree_groups=_tree_groups(l))
                b, h, w = y5.shape[:3]
                cur = y5.reshape(b, h, w, -1)
                heads.append(HeadOutput(i, "region", y5))
            elif isinstance(l, SoftmaxSpec):
                cur_i8 = None
                cur = cur.to(torch.float32)     # head math stays float32
                cur = L.softmax_layer(cur.reshape(cur.shape[0], -1), l.groups,
                                      l.temperature,
                                      tree_groups=_tree_groups(l))
            else:
                raise _not_ported(f"layer {type(l).__name__}")
            if i in kept:
                outputs[i] = cur
            if i not in route_srcs:
                i8_outputs.pop(i, None)
            if layer_hook is not None:
                layer_hook(i)
        aux = {"final": cur}
        if capture_conv_inputs:
            aux["conv_inputs"] = conv_inputs
        if carry_out is not None:
            aux["outputs"] = {j: outputs[j] for j in carry_out}
        if int8_targets is not None:
            aux["i8"] = {"cur": cur_i8,
                         "outputs": {j: i8_outputs[j] for j in carry_out or ()
                                     if j in i8_outputs}}
        return tuple(heads), aux

    return forward


# the layer types the reference's old INT8 pipeline executes
_OLD_LAYERS = (ConvSpec, MaxpoolSpec, RouteSpec, ReorgSpec, RegionSpec)
# the hardcoded requantization of layer 0's float output
# (src/yolov2_forward_network_quantized.c:1147)
_OLD_LAYER0_MULT = 3.88677


def _old_stores(spec: ModelSpec, int8_set: set) -> dict:
    """For each int8 conv of the old chain, the store its readers need:
    ``int8_conv.OLD_BOTH``, torch.float32 or torch.int8. The float output
    feeds a following float conv (a LINEAR one) or region head and the
    forward's final output; the int8 output feeds a following int8 conv,
    maxpool or reorg, any route that names the layer, and what reads a
    region's int8 output, which is its predecessor's. A conv nothing reads
    stores int8."""
    reads_f, reads_i8 = {spec.n - 1}, set()
    for l in reversed(spec.layers):
        i = l.index
        if isinstance(l, RouteSpec):
            reads_i8.update(l.layers)
        if i == 0:
            continue
        if isinstance(l, RegionSpec):
            reads_f.add(i - 1)
            if i in reads_i8:
                reads_i8.add(i - 1)
        elif isinstance(l, ConvSpec) and i not in int8_set:
            reads_f.add(i - 1)
        elif not isinstance(l, RouteSpec):
            reads_i8.add(i - 1)
    out = {}
    for i in int8_set:
        f, q = i in reads_f, i in reads_i8
        out[i] = (int8_conv.OLD_BOTH if f and q
                  else torch.float32 if f else torch.int8)
    return out


def build_forward_int8_old(spec: ModelSpec, plain: bool = False):
    """Legacy fully-INT8 pipeline (reference: yolov2_forward_network_q_old +
    network_predict_quantized_old,
    src/yolov2_forward_network_quantized.c:1092-1211, present in the
    reference but unreachable from its CLI), the JAX package's
    ``build_forward_int8_old``.

    int8 activations chain between layers: maxpool (window origin ``-pad``,
    ``layers.maxpool_int8_old``), route and reorg run on int8. Convs with
    LINEAR activation and layer 0 run float32 (on the float output of their
    predecessor, q / 16 after an int8 conv, zeros after a maxpool, route or
    reorg); layer 0's output is requantized with the reference's hardcoded
    3.88677; a float conv after layer 0 leaves a zero int8 output. Every
    other conv is one launch of the int8 kernel's "old" epilogue
    (``plain``: its plain twin), which stores what its readers take
    (``_old_stores``): both outputs in one launch where both are read.
    Only conv, maxpool, route, reorg and region layers run, as in the
    reference (``_check_ported`` raises for the others).
    """
    int8_set = _int8_layer_set(spec, "cpu_old")
    stores = _old_stores(spec, int8_set)
    route_srcs = {j for l in spec.layers if isinstance(l, RouteSpec)
                  for j in l.layers}
    L.set_fp32_precision()

    def zeros(shape, dtype, like):
        return torch.zeros(shape, dtype=dtype, device=like.device)

    def forward(params, x):
        # cur_f / cur_i8 hold a layer's float and int8 outputs (one shape);
        # None stands for zeros (a float conv's int8 output, a maxpool's,
        # route's or reorg's float output) or an output nothing reads
        int8_outs: dict[int, torch.Tensor] = {}
        heads: list[HeadOutput] = []
        cur_f, cur_i8, shape = x, None, tuple(x.shape)

        def f_in():
            return cur_f if cur_f is not None else zeros(shape,
                                                         torch.float32, x)

        def i8_in():
            return cur_i8 if cur_i8 is not None else zeros(shape,
                                                           torch.int8, x)

        for l in spec.layers:
            i = l.index
            if isinstance(l, ConvSpec):
                p = params[i]
                if i in int8_set:
                    cur_f, cur_i8 = L.conv2d_int8_old(
                        i8_in(), p["weights_int8"], p["biases_quant"],
                        p["output_multipler"], l.stride, l.pad,
                        l.activation, plain=plain, store=stores[i])
                else:
                    bn = None
                    if "scales" in p:
                        bn = (p["scales"], p["rolling_mean"],
                              p["rolling_variance"])
                    cur_f = L.conv2d_fp32(f_in(), p["weights"], p["biases"],
                                          l.stride, l.pad, l.activation,
                                          bn=bn)
                    cur_i8 = (L.quantize_i8(cur_f, _OLD_LAYER0_MULT)
                              if i == 0 else None)
                shape = (shape[0], l.out_h, l.out_w, l.n)
            elif isinstance(l, MaxpoolSpec):
                cur_i8 = L.maxpool_int8_old(i8_in(), l.size, l.stride, l.pad,
                                            l.out_w, l.out_h)
                cur_f, shape = None, tuple(cur_i8.shape)
            elif isinstance(l, RouteSpec):
                cur_i8 = torch.cat([int8_outs[j] for j in l.layers], dim=-1)
                cur_f, shape = None, tuple(cur_i8.shape)
            elif isinstance(l, ReorgSpec):
                cur_i8 = L.reorg(i8_in(), l.stride, l.reverse)
                cur_f, shape = None, tuple(cur_i8.shape)
            else:   # RegionSpec; the int8 output passes through
                y5 = L.region_head(f_in(), l.n, l.classes, l.coords,
                                   l.softmax)
                cur_f = y5.reshape(shape)
                heads.append(HeadOutput(i, "region", y5))
            if i in route_srcs:
                int8_outs[i] = i8_in()
        return tuple(heads), {"final": f_in()}

    return forward


def device_params(spec: ModelSpec, params: list, mode: str, device, *,
                  int8_policy: str = "cpu", xnor_impl: str = "int8",
                  compute_dtype=torch.float32) -> list:
    """``params`` on ``device`` through ``params.params_to_torch``, each conv
    keeping only the weights of the path it runs: in int8 mode the int8
    convs their int8 weights, an XNOR conv those of its engines; the float
    convs' weights in ``compute_dtype`` (float32 under ``cpu_old``)."""
    int8_set = _int8_layer_set(spec, int8_policy) if mode == "int8" else ()
    old = mode == "int8" and int8_policy == "cpu_old"
    drops = [_dropped_fields(l, int8_set, xnor_impl, old)
             for l in spec.layers]
    # the old chain's float convs run in float32 whatever compute_dtype says
    return params_to_torch(params, device, drops,
                           torch.float32 if old else compute_dtype)


def load_kernels(spec: ModelSpec, mode: str, *, int8_policy: str = "cpu",
                 int8_impl: str = "xla", xnor_impl: str = "int8",
                 compute_dtype=torch.float32) -> None:
    """Build and bind the hand kernels a forward of ``spec`` launches on the
    card, so that the first forward does not include their builds."""
    if int8_impl in ("plain", "fused_plain"):
        return
    int8_set = _int8_layer_set(spec, int8_policy) if mode == "int8" else ()
    if compute_dtype == torch.bfloat16 and not (mode == "int8" and
                                                int8_policy == "cpu_old"):
        bf16_conv.load_kernel()
    if mode == "int8":
        int8_conv.load_kernel()
        if int8_policy == "cpu_old":   # the old chain runs K1 alone
            return
        if any(l.activation == "mish" for l in spec.conv_layers()
               if l.index in int8_set):
            int8_conv.load_kernel(mish=True)
        if int8_impl == "fused":
            fused_res.load_kernel()
    if any(isinstance(l, ConvSpec) and l.xnor and _bit_path(l)
           and l.index not in int8_set for l in spec.layers):
        if xnor_impl == "pallas":
            xnor_gemm.load_kernel("xnor_gemm")
        elif xnor_impl in ("pallas_mxu", "auto"):
            xnor_gemm.load_kernel("xnor_gemm_mxu")


class Predictor(nn.Module):
    """One call, image(s) in, head maps out, on one explicit device.

    The converted params are the module's buffers (``l<index>_<name>``); the
    int8 scalars (input multiplier, alpha, inv) are plain floats. Each conv keeps
    only the weights of the path it runs: in int8 mode the int8 convs their
    int8 weights, an XNOR conv those of its engines. On a CUDA device the
    kernels are built here, so the first forward does not include the build.
    """

    def __init__(self, spec: ModelSpec, params: list, mode: str = "fp32", *,
                 device="cuda", int8_policy: str = "cpu",
                 int8_impl: str = "xla", xnor_impl: str = "int8",
                 compute_dtype=torch.float32, turbo=False,
                 int8_chain: bool = True):
        super().__init__()
        self.spec = spec
        self.mode = mode
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (use device='cpu' to "
                               "run the plain PyTorch path)")
        self._forward = build_forward(spec, mode, int8_policy=int8_policy,
                                      int8_impl=int8_impl, xnor_impl=xnor_impl,
                                      compute_dtype=compute_dtype, turbo=turbo,
                                      int8_chain=int8_chain)
        self._layout: list = []   # per layer: None or (tensor names, scalars)
        for i, p in enumerate(device_params(spec, params, mode, self.device,
                                            int8_policy=int8_policy,
                                            xnor_impl=xnor_impl,
                                            compute_dtype=compute_dtype)):
            if p is None:
                self._layout.append(None)
                continue
            names, scalars = [], {}
            for k, v in p.items():
                if isinstance(v, torch.Tensor):
                    self.register_buffer(f"l{i}_{k}", v)
                    names.append(k)
                else:
                    scalars[k] = v
            self._layout.append((names, scalars))
        if self.device.type == "cuda":
            load_kernels(spec, mode, int8_policy=int8_policy,
                         int8_impl=int8_impl, xnor_impl=xnor_impl,
                         compute_dtype=compute_dtype)

    def layer_params(self) -> list:
        """The per-layer param dicts ``forward`` reads, from the buffers."""
        out = []
        for i, entry in enumerate(self._layout):
            if entry is None:
                out.append(None)
                continue
            names, scalars = entry
            d = dict(scalars)
            for k in names:
                d[k] = getattr(self, f"l{i}_{k}")
            out.append(d)
        return out

    def forward(self, x) -> tuple:
        x = torch.as_tensor(x).to(self.device, torch.float32)
        # dense NHWC strides: a batch of one whose batch stride is 0 (NumPy's
        # ``im[None]``) does not read as channels-last to cuDNN, which then
        # runs the first conv in NCHW, and the int8 conv after it would have
        # to copy its input dense
        x = x.reshape(-1).view(x.shape)
        with torch.inference_mode():
            heads, _ = self._forward(self.layer_params(), x)
        return heads

    def head_specs(self):
        return [l for l in self.spec.layers
                if isinstance(l, (YoloSpec, RegionSpec))]
