"""Multi-device sharding on explicit device positions: data-parallel batch,
spatial-parallel rows and tensor-parallel conv channels.

Counterpart of ``yolo2_light_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process places shards on a ``jax.sharding.Mesh`` and
XLA's GSPMD inserts the collectives. This module is the same design in
PyTorch: one process, a grid of device *positions* ``(data, space, model)``,
each a ``torch.device`` with, on CUDA, a stream of its own, and the
collectives GSPMD inserted written out as copies between positions. Runs of
layers that need no collective go through ``network.build_forward(
layer_range=...)`` on every position, so there is one forward loop; the
collectives sit between the runs, here, never in ``layers.py`` or a kernel.
Every hand kernel launches on the current stream, so a position runs the
same kernels inside ``torch.cuda.stream(its stream)``.

A position may repeat a device: n positions on one GPU are n streams there,
and on the CPU every position is the CPU (as the JAX tests run 8 virtual
host devices). On a machine with several GPUs the positions default to
``cuda:0 .. n-1`` and the copies between them go peer to peer.

Axes:

* ``data``: the batch; no collective.
* ``model``: the output channels of the convs whose params shard
  (:func:`shard_params`): each model position computes its M/model
  channels from the full input, then an all-gather (the pieces handed to
  every position of the group and a ``torch.cat`` in channel order), right
  after the conv or after the maxpools that alone read its output (they act
  per channel on the pieces, and a pooled map is smaller). Every other layer
  runs whole on each model position.
* ``space``: activation rows. The partition is defined on the net's coarsest
  grid (13 rows at 416) and scaled by each map's height over it, so every
  slab boundary lines up with the stride-2 convs, upsample, reorg and
  routes; slabs may be uneven (13 rows over 2 give 7 and 6). Before a
  windowed layer (a conv or maxpool whose output rows read rows outside
  their slab), each position takes the rows it reads from its neighbours,
  runs the layer unchanged with its own padding, and drops the output rows
  that the artificial padding at an interior edge produced; the global edges
  keep the op's own padding (the XNOR -1 border, maxpool's fill). Heads are
  gathered along rows at the end, onto the first position.

Every collective here reports what it moves to ``commvol``'s recorder when
that is on (``commvol.recording``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..cfg import (ConvSpec, MaxpoolSpec, ModelSpec, RouteSpec, ShortcutSpec,
                   SoftmaxSpec)
from ..models.network import (HeadOutput, _consumers, build_forward,
                              device_params, load_kernels)
from . import commvol

AXES = ("data", "space", "model")


def cuda_devices() -> list:
    """Every CUDA device of the machine, in order; raises where there is
    none."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (use device='cpu' to run "
                           "the plain PyTorch path)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _normal(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Position:
    """One place of a mesh or a pipeline: a device and, on CUDA, a stream
    of its own (or the ``stream`` given, e.g. a caller's current one)."""

    def __init__(self, index, device, stream=None):
        self.index = index
        self.device = _normal(device)
        if stream is None and self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
        self.stream = stream

    @classmethod
    def current(cls, device) -> "Position":
        """The caller: ``device`` with its current stream."""
        device = _normal(device)
        return cls(None, device, torch.cuda.current_stream(device)
                   if device.type == "cuda" else None)

    def scope(self):
        """Work issued inside runs on this position's stream."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())


def handoff(t: torch.Tensor, src: Position, dst: Position) -> torch.Tensor:
    """``t``, made on ``src``'s stream, made readable on ``dst``'s.

    On one device it is the same tensor: ``dst``'s stream waits for the work
    queued on ``src``'s so far, and ``record_stream`` keeps the caching
    allocator from handing its block out again before ``dst``'s stream is
    done with it. Across devices it is a copy onto ``dst``'s device, issued
    with both streams current (PyTorch orders a device-to-device copy after
    the current streams of both devices)."""
    if src.device != dst.device:
        with src.scope(), dst.scope():
            return t.to(dst.device, non_blocking=True)
    if src.stream is not None and src.stream != dst.stream:
        dst.stream.wait_stream(src.stream)
        t.record_stream(dst.stream)
    return t


def join(tensors, pos: Position) -> None:
    """Hand ``tensors``, made on ``pos``'s stream, to the current stream of
    their device: it waits for ``pos``'s work, so a host read after it sees
    the results."""
    if pos.stream is None:
        return
    cur = torch.cuda.current_stream(pos.device)
    if cur != pos.stream:
        cur.wait_stream(pos.stream)
        for t in tensors:
            t.record_stream(cur)


class Mesh:
    """Positions in a ``(data, space, model)`` grid. ``shape``: the axis
    sizes by name, as a ``jax.sharding.Mesh``'s; ``positions``: every
    position, data-major (model fastest)."""

    axis_names = AXES

    def __init__(self, devices, data: int = 1, space: int = 1,
                 model: int = 1):
        if len(devices) != data * space * model:
            raise ValueError(f"{len(devices)} devices for a mesh of "
                             f"{data} x {space} x {model} positions")
        self.shape = {"data": data, "space": space, "model": model}
        self.positions = [
            Position((d, s, m), devices[(d * space + s) * model + m])
            for d in range(data) for s in range(space)
            for m in range(model)]

    @property
    def size(self) -> int:
        return len(self.positions)

    def position(self, d: int, s: int, m: int) -> Position:
        return self.positions[
            (d * self.shape["space"] + s) * self.shape["model"] + m]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None, space: int | None = None, *,
              devices=None, device="cuda") -> Mesh:
    """Build a (data, space, model) mesh over the first n devices.

    Unspecified axes default to 1 except when ALL are unspecified, where the
    auto-split favors data parallelism with a modest model axis (throughput
    serving), as in the JAX package. The devices: ``devices`` (a list that
    may repeat a device; a shorter one than the mesh needs raises, it never
    shrinks the mesh), else ``cuda:0 .. device_count()-1`` for ``device``
    "cuda", else (``device="cpu"``) every position on the CPU."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif torch.device(device).type == "cpu":
        devs = None                      # the CPU holds any number
    else:
        devs = cuda_devices()
    n = n_devices or (len(devs) if devs is not None else 1)
    if data is None and model is None and space is None:
        # favor data parallelism: the model axis stays modest (at most 2)
        # and only when the device count leaves data with the larger share
        model = 2 if n % 2 == 0 and n >= 4 else 1
        data = n // model
        space = 1
    else:
        data, model, space = data or 1, model or 1, space or 1
    need = data * space * model
    have = len(devs) if devs is not None else need
    if need > have:
        raise ValueError(
            f"mesh data={data} x space={space} x model={model} needs "
            f"{need} devices, have {have}")
    if devs is None:
        devs = [torch.device("cpu")] * need
    return Mesh(devs[:need], data=data, space=space, model=model)


def sharded_layers(spec: ModelSpec, mesh: Mesh) -> set:
    """The convs whose params shard over ``model``: those with M % model
    == 0 where ``space`` is 1, or the kernel is 1x1 (the JAX package's
    rule). The JAX package keeps the spatial kernels replicated under a
    space axis because XLA's SPMD partitioner miscompiles a row-partitioned
    conv with a channel-sharded kernel; the port has no such fault, but
    keeps the rule so that both packages shard the same layers."""
    model, space = mesh.shape["model"], mesh.shape["space"]
    if model == 1:
        return set()
    return {l.index for l in spec.layers
            if isinstance(l, ConvSpec) and l.n % model == 0
            and (space == 1 or l.size == 1)}


def shard_params(spec: ModelSpec, params: list, mesh: Mesh) -> list:
    """The params of every position (a list in ``mesh.positions`` order,
    each a per-layer list): the per-output-channel tensors of the convs of
    :func:`sharded_layers` (weights in every layout the port keeps — float,
    int8, K6's ``weights_k32``, the XNOR signs and packed bits — biases, BN
    vectors and XNOR means, all with M first) sliced to the position's
    M/model rows, everything else whole on its device. The int8 scalars
    (multipliers, alpha, the gpu policy's inv: one per layer) replicate as
    the Python floats they are. ``params``: ``params.params_to_torch``'s
    layout (``network.device_params``) on any device; a tensor is moved once
    per device and shared by the positions there."""
    shard = sharded_layers(spec, mesh)
    model = mesh.shape["model"]
    made: dict = {}
    out = []
    for pos in mesh.positions:
        part = pos.index[2]
        per_layer = []
        for l, p in zip(spec.layers, params):
            if p is None:
                per_layer.append(None)
                continue
            q = {}
            for k, v in p.items():
                if not isinstance(v, torch.Tensor):
                    q[k] = v
                    continue
                cut = (l.index in shard and v.dim() >= 1
                       and v.shape[0] == l.n)
                key = (l.index, k, part if cut else None, pos.device)
                t = made.get(key)
                if t is None:
                    if cut:
                        m = l.n // model
                        v = v[part * m:(part + 1) * m]
                    t = made[key] = v.to(pos.device)
                q[k] = t
            per_layer.append(q)
        out.append(per_layer)
    return out


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------


def _row_grid(spec: ModelSpec, space: int) -> tuple:
    """(coarse rows, slab bounds on them) of a ``space``-way row split;
    raises where the net's maps cannot be split by rows."""
    for l in spec.layers:
        if isinstance(l, SoftmaxSpec):
            raise ValueError("a [softmax] layer reads its whole map: the "
                             "space axis (-sp) cannot split this net's rows")
        if isinstance(l, RouteSpec) and l.out_c == 0:
            raise ValueError(f"route {l.index} joins maps of different "
                             "sizes: the space axis (-sp) cannot split "
                             "this net's rows")
        if (isinstance(l, ShortcutSpec)
                and spec.layers[l.from_index].out_h != l.out_h):
            raise ValueError(f"shortcut {l.index} adds maps of different "
                             "sizes: the space axis (-sp) cannot split "
                             "this net's rows")
    heights = [spec.net.h] + [l.out_h for l in spec.layers]
    coarse = min(heights)
    if coarse < 1 or any(h % coarse for h in heights):
        raise ValueError("the space axis (-sp) needs every map height to be "
                         f"a multiple of the coarsest ({coarse})")
    if space > coarse:
        raise ValueError(f"space={space} positions but the net's coarsest "
                         f"grid has {coarse} rows: at most one position a "
                         "row")
    sizes = [len(a) for a in np.array_split(np.arange(coarse), space)]
    return coarse, np.concatenate([[0], np.cumsum(sizes)]).tolist()


class _Segment:
    """A run of layers ``[a, b)`` between collectives: ``halo`` (one
    windowed layer fed its neighbours' rows: per space index, the input rows
    ``ext`` it reads and the output rows ``keep`` it keeps), ``gather``
    (its last layer is a model-sharded conv)."""

    def __init__(self, a, b, fwd, halo=None, gather=False):
        self.a, self.b, self.fwd = a, b, fwd
        self.halo = halo
        self.gather = gather


def _origin(l) -> int:
    """How many rows above its first a conv's or maxpool's window starts."""
    return l.pad if isinstance(l, ConvSpec) else l.pad // 2


def _out_rows(l, n: int) -> int:
    """Output rows of a conv or maxpool on an n-row input, as the forward
    computes them."""
    pad = 2 * l.pad if isinstance(l, ConvSpec) else l.pad
    return (n + pad - l.size) // l.stride + 1


class ShardedForward:
    """``forward(sharded_params, x, carried=None) -> (heads, aux)`` over a
    :class:`Mesh`, ``network.build_forward``'s signature: the heads, and
    ``aux["final"]`` and ``aux["outputs"]`` (``carry_out``), gathered onto
    the mesh's first position and handed to the current stream of its
    device. ``layer_range``/``carry_out``/``carried`` run a part of the net,
    as ``build_forward``'s do (a pipeline stage under ``-pp_tp``). The runs
    between collectives carry the int8 chain's state across their ends
    (``build_forward``'s ``int8_targets``), so every mode computes the
    unsplit range's function.
    ``prepare``, where given, runs on each data group's input on that
    group's first position before the rows are split (the pipeline's
    ingest). The other keywords are ``build_forward``'s."""

    def __init__(self, spec: ModelSpec, mesh: Mesh, mode: str = "fp32", *,
                 layer_range=None, carry_out=None, **kw):
        self.spec, self.mesh = spec, mesh
        lo, hi = (0, spec.n) if layer_range is None else layer_range
        self.carry_out = carry_out
        space = mesh.shape["space"]
        shard = sharded_layers(spec, mesh)
        self.rows = _row_grid(spec, space) if space > 1 else None
        halo = {}
        if self.rows is not None:
            for l in spec.layers[lo:hi]:
                if isinstance(l, (ConvSpec, MaxpoolSpec)):
                    plan = self._halo_plan(l)
                    if plan is not None:
                        halo[l.index] = plan
        consumers = _consumers(spec)
        # where each sharded conv's channels are gathered: after the
        # maxpools that alone read its output (they act per channel, and a
        # pooled map is smaller), else right after the conv
        gather_at = set()
        for i in shard & set(range(lo, hi)):
            while (i + 1 < hi and consumers[i] == [i + 1]
                   and i not in (carry_out or ())
                   and isinstance(spec.layers[i + 1], MaxpoolSpec)):
                i += 1
            gather_at.add(i)
        cuts = {lo, hi} | {i + 1 for i in gather_at}
        for i in halo:
            cuts |= {i, i + 1}
        bounds = sorted(cuts)
        self.whole = (len(bounds) == 2 and layer_range is None
                      and carry_out is None)
        if not self.whole and mode == "int8" and \
                kw.get("int8_policy") == "cpu_old":
            raise ValueError(
                "-int8_policy cpu_old runs its legacy int8 chain as one "
                "forward: it shards over the data axis (-parallel) only, "
                "not over -tp/-sp or pipeline stages")
        self.segments = []
        for a, b in zip(bounds, bounds[1:]):
            # what a later run of this range, or a later range, reads
            out = {j for j in range(b)
                   if any(b <= c < hi for c in consumers[j])}
            out |= {j for j in carry_out or () if j < b}
            fwd = (build_forward(spec, mode, **kw) if self.whole else
                   build_forward(spec, mode, layer_range=(a, b),
                                 carry_out=out, int8_targets=(lo, hi),
                                 **kw))
            self.segments.append(_Segment(
                a, b, fwd, halo=halo.get(a) if b == a + 1 else None,
                gather=(b - 1) in gather_at))
        if any(p.device.type == "cuda" for p in mesh.positions):
            load_kernels(spec, mode, **{k: v for k, v in kw.items()
                                        if k in ("int8_policy", "int8_impl",
                                                 "xnor_impl",
                                                 "compute_dtype")})

    # ---- rows --------------------------------------------------------------

    def slab(self, h: int, s: int) -> tuple:
        """Rows [r0, r1) of space position ``s`` in a map of ``h`` rows."""
        if self.rows is None:
            return 0, h
        coarse, b = self.rows
        return b[s] * h // coarse, b[s + 1] * h // coarse

    def _halo_plan(self, l):
        """Per space index (input rows read, output rows kept of the local
        output, the first input row a kept output reads), or None where
        every slab's own rows suffice."""
        h_in = self.spec.net.h if l.index == 0 else \
            self.spec.layers[l.index - 1].out_h
        h_out = l.out_h
        space = self.mesh.shape["space"]
        plan, local = [], True
        for s in range(space):
            i0, i1 = self.slab(h_in, s)
            o0, o1 = self.slab(h_out, s)
            size, stride, origin = l.size, l.stride, _origin(l)
            # the first input row read, at a multiple of the stride so that
            # the local output rows fall on the global grid
            n0 = max(0, o0 * stride - origin)
            e0 = n0 // stride * stride
            e1 = min(h_in, (o1 - 1) * stride - origin + size)
            keep = (o0 - e0 // stride, o1 - e0 // stride)
            assert _out_rows(l, e1 - e0) >= keep[1], (l.index, s)
            plan.append(((e0, e1), keep, n0))
            if not ((s == 0 or o0 * stride - origin >= i0)
                    and (s == space - 1
                         or (o1 - 1) * stride - origin + size <= i1)
                    and _out_rows(l, i1 - i0) == o1 - o0):
                local = False
        return None if local else plan

    # ---- the call ----------------------------------------------------------

    def __call__(self, params: list, x: torch.Tensor, carried=None, *,
                 prepare=None):
        mesh = self.mesh
        D, S, M = (mesh.shape[a] for a in AXES)
        caller = Position.current(x.device)
        if x.shape[0] % D:
            raise ValueError(f"batch {x.shape[0]} not divisible by the data "
                             f"axis ({D})")
        if S > 1 and x.dim() != 4:
            raise ValueError("planar YUV420 frames [B, H*3/2, W] have no row "
                             "split: the space axis (-sp) needs [B,H,W,C] "
                             "frames")
        b = x.shape[0] // D
        # per position: its tensors by key ("x": the running activation,
        # ("o", j): output j that a later run reads, "q" and ("qo", j): the
        # int8 tensors of the running and carried int8 chain pairs) and the
        # pairs' targets
        T = {}
        meta = {p: {"cur": None, "outputs": {}} for p in mesh.positions}
        heads = {p: [] for p in mesh.positions}
        # the caller stands where the first position is: what it hands there
        # crosses nothing
        log = commvol.current()
        lo = self.segments[0].a
        for d in range(D):
            xd, src, src_at = x[d * b:(d + 1) * b], caller, mesh.positions[0]
            if prepare is not None:
                first = mesh.position(d, 0, 0)
                xd = handoff(xd, caller, first)
                if log is not None and first is not src_at:
                    log.point("scatter", first.index, xd, -1)
                with first.scope():
                    xd = prepare(xd)
                src = src_at = first
            for s in range(S):
                for m in range(M):
                    p = mesh.position(d, s, m)
                    T[p] = {"x": self._piece(xd, s, src, p, src_at, lo - 1)}
                    for j, v in (carried or {}).items():
                        # the running activation, carried too, crosses once
                        T[p][("o", j)] = (
                            T[p]["x"] if v is x and prepare is None else
                            self._piece(v[d * b:(d + 1) * b], s, caller, p,
                                        mesh.positions[0], j))
        for seg in self.segments:
            if seg.halo is not None:
                self._apply(T, ("x", "q"),
                            lambda t, p: self._extend(t, p, seg.halo,
                                                      seg.a - 1))
            for p, pp in zip(mesh.positions, params):
                with p.scope():
                    if self.whole:
                        hs, aux = seg.fwd(pp, T[p]["x"])
                    else:
                        hs, aux = seg.fwd(pp, T[p]["x"], _outputs(T[p]),
                                          _pairs(T[p], meta[p]))
                    T[p], meta[p] = _state(aux)
                    heads[p].extend(hs)
            # the tensors of the run's last output
            last = ("x", ("o", seg.b - 1), "q", ("qo", seg.b - 1))
            if seg.halo is not None:
                self._apply(T, last, lambda t, p: self._trim(t, p, seg.halo))
            if seg.gather:
                self._apply(T, last,
                            lambda t, p: self._all_gather(t, p, seg.b - 1))
        first = mesh.positions[0]
        out = tuple(HeadOutput(h.index, h.kind, self._collect(
            {p: heads[p][n].data for p in heads}, h.index))
            for n, h in enumerate(heads[first]))
        last = self.segments[-1].b - 1
        if out and out[-1].index == last:
            # the final output is the last head's map: reshaped, not moved
            # again
            final = out[-1].data.reshape(*out[-1].data.shape[:3], -1)
        else:
            final = self._collect({p: T[p]["x"] for p in T}, last)
        aux = {"final": final}
        if self.carry_out is not None:
            aux["outputs"] = {
                j: final if T[first][("o", j)] is T[first]["x"] else
                self._collect({p: T[p][("o", j)] for p in T}, j)
                for j in self.carry_out}
        join([h.data for h in out] + [aux["final"]]
             + list(aux.get("outputs", {}).values()), first)
        return out, aux

    def _apply(self, T: dict, keys, collective) -> None:
        """Replace the tensors under ``keys`` on every position by
        ``collective({position: tensor}, position)``; a tensor that two keys
        name (an output that is also the running activation) goes through
        the collective once."""
        done: dict = {}
        first = self.mesh.positions[0]
        for k in keys:
            if k not in T[first]:
                continue
            ident = tuple(id(T[p][k]) for p in T)
            if ident not in done:
                per = {p: T[p][k] for p in T}
                done[ident] = {p: collective(per, p) for p in T}
            for p in T:
                T[p][k] = done[ident][p]

    def _trim(self, per: dict, p: Position, plan) -> torch.Tensor:
        """Position ``p``'s output rows of a windowed layer run on its
        extended rows: those the artificial padding did not reach."""
        y = per[p]
        k0, k1 = plan[p.index[1]][1]
        if (k0, k1) == (0, y.shape[1]):
            return y
        with p.scope():
            return y[:, k0:k1].contiguous()

    def _piece(self, t, s: int, src: Position, p: Position,
               src_at: Position, layer: int):
        """Space position ``s``'s rows of ``t`` (made on ``src``, which
        stands where ``src_at`` is), dense, on ``p``."""
        if t.dim() == 4:
            r0, r1 = self.slab(t.shape[1], s)
            if (r0, r1) != (0, t.shape[1]):
                t = t[:, r0:r1]
        t = handoff(t, src, p)
        log = commvol.current()
        if log is not None and p is not src_at:
            log.point("scatter", p.index, t, layer)
        if t.is_contiguous():
            return t
        with p.scope():
            return t.contiguous()

    def _extend(self, cur: dict, p: Position, plan,
                layer: int) -> torch.Tensor:
        """The halo exchange: the input rows position ``p``'s windowed
        layer reads, from its own slab and its neighbours' in the column.
        Rows above the first one a kept output reads (where the window
        starts at a multiple of the stride, so that the output rows fall on
        the global grid) feed only output rows that are dropped: they are
        zeros made here, not rows moved."""
        d, s, m = p.index
        (e0, e1), _, n0 = plan[s]
        h = sum(cur[self.mesh.position(d, q, m)].shape[1]
                for q in range(self.mesh.shape["space"]))
        log = commvol.current()
        pieces = []
        for q in range(self.mesh.shape["space"]):
            qp = self.mesh.position(d, q, m)
            a, b = self.slab(h, q)
            r0, r1 = max(n0, a), min(e1, b)
            if r0 < r1:
                t = cur[qp]
                if (r0, r1) != (a, b):
                    t = t[:, r0 - a:r1 - a]
                pieces.append(handoff(t, qp, p))
                if log is not None and q != s:
                    log.point("halo", p.index, t, layer)
        with p.scope():
            if n0 > e0:
                t = pieces[0]
                pieces.insert(0, t.new_zeros((t.shape[0], n0 - e0)
                                             + tuple(t.shape[2:])))
            if len(pieces) == 1:
                return pieces[0].contiguous()
            return torch.cat(pieces, dim=1)

    def _all_gather(self, cur: dict, p: Position,
                    layer: int) -> torch.Tensor:
        """The model group's channel pieces of ``p``'s (data, space) cell,
        on ``p``, in channel order."""
        d, s, _ = p.index
        pieces = []
        for m in range(self.mesh.shape["model"]):
            q = self.mesh.position(d, s, m)
            pieces.append(handoff(cur[q], q, p))
        with p.scope():
            out = torch.cat(pieces, dim=-1)
        log = commvol.current()
        if log is not None:
            log.add("all-gather", "gather", p.index, commvol.nbytes(out),
                    len(pieces), layer)
        return out

    def _collect(self, per_pos: dict, layer: int) -> torch.Tensor:
        """The model-0 positions' pieces joined along rows (space) and the
        batch (data), on the first position."""
        mesh = self.mesh
        first = mesh.positions[0]
        log = commvol.current()
        groups = []
        for d in range(mesh.shape["data"]):
            rows = []
            for s in range(mesh.shape["space"]):
                q = mesh.position(d, s, 0)
                rows.append(handoff(per_pos[q], q, first))
                if log is not None and q is not first:
                    log.point("collect", first.index, per_pos[q], layer)
            groups.append(rows)
        with first.scope():
            parts = [r[0] if len(r) == 1 else torch.cat(r, dim=1)
                     for r in groups]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _outputs(t: dict) -> dict:
    """The carried outputs among a position's tensors."""
    return {k[1]: v for k, v in t.items() if isinstance(k, tuple)
            and k[0] == "o"}


def _pairs(t: dict, meta: dict) -> dict:
    """``build_forward``'s int8 state from a position's tensors and the
    pairs' targets."""
    cur = meta["cur"]
    return {"cur": None if cur is None else (t.get("q"), cur),
            "outputs": {j: (t.get(("qo", j)), tgt)
                        for j, tgt in meta["outputs"].items()}}


def _state(aux: dict) -> tuple:
    """A run's results as a position's tensors and the pairs' targets."""
    t = {"x": aux["final"]}
    t.update({("o", j): v for j, v in aux.get("outputs", {}).items()})
    i8 = aux.get("i8", {})
    meta = {"cur": None, "outputs": {}}
    pair = i8.get("cur")
    if pair is not None:
        meta["cur"] = pair[1]
        if pair[0] is not None:
            t["q"] = pair[0]
    for j, (q, tgt) in i8.get("outputs", {}).items():
        meta["outputs"][j] = tgt
        if q is not None:
            t[("qo", j)] = q
    return t, meta


def make_sharded_predict(spec: ModelSpec, params: list, mesh: Mesh,
                         mode: str = "fp32", compute_dtype=torch.float32,
                         **kw):
    """Batched forward with the batch split over ``data``, rows over
    ``space`` and conv channels over ``model``. Returns ``(fn,
    sharded_params)``; call as ``fn(sharded_params, x)``, which returns the
    head maps (``HeadOutput.data``), gathered onto the first position.
    ``params``: the host params of ``apps/detect.build_params``; ``kw``: the
    other ``build_forward`` keywords (``int8_policy``, ``int8_impl``,
    ``xnor_impl``, ``turbo``)."""
    params = device_params(spec, params, mode, "cpu",
                           int8_policy=kw.get("int8_policy", "cpu"),
                           xnor_impl=kw.get("xnor_impl", "int8"),
                           compute_dtype=compute_dtype)
    fwd = ShardedForward(spec, mesh, mode, compute_dtype=compute_dtype, **kw)
    sharded = shard_params(spec, params, mesh)

    def step(p, x):
        x = torch.as_tensor(x).to(mesh.positions[0].device, torch.float32)
        with torch.inference_mode():
            heads, _ = fwd(p, x)
        return tuple(h.data for h in heads)

    return step, sharded
