"""Communication-volume accounting for the port's multi-device axes.

Counterpart of ``yolo2_light_tpu/parallel/commvol.py``. The JAX package reads
its collectives out of the compiled SPMD HLO; the port's collectives are
explicit Python calls in ``parallel/mesh.py`` and ``parallel/pp.py``, so it
counts them where they run: a recorder, off by default and turned on by
:func:`recording`, takes one entry for every copy that reaches another
position. It counts by positions, not by devices: with every position on one
card a hand-over moves nothing (``mesh.handoff``), but the count is what the
same program moves with one device per position. When off it costs one
``None`` test a collective: no tensor op and no host sync (bytes come from
shapes).

Each entry: op class, what it is, the receiving position, the bytes the
collective materialises there, its participant count and the layer whose
output crosses (-1: the input image). The op classes are JAX's five; the
port's collectives map onto them so that :func:`wire_bytes`' factors hold:

====================================  ==================  =====================  =====
port collective                       op class            bytes recorded          group
====================================  ==================  =====================  =====
``ShardedForward._all_gather``,       all-gather          the gathered tensor     model
the model group's channel pieces                          (every piece, own too)
after a model-sharded conv
``ShardedForward._extend``, the       collective-permute  the rows one neighbour  2
halo rows a windowed layer reads                          sends (an entry each)
under ``space``
``ShardedForward._piece``, the        collective-permute  the piece               2
input's (and carried tensors') rows
handed from the caller to a position
``ShardedForward._collect``, heads    collective-permute  the piece one position  2
and outputs onto the first position                       sends (an entry each)
``pp.PipelinedPredictor``, a stage    collective-permute  each tensor, once       2
boundary's running activation and
carried outputs; heads onto the last
stage; ``ReplicatedPipeline``'s
slices and heads
====================================  ==================  =====================  =====

Wire bytes (received per position) from result bytes, as in the JAX module:

  * all-gather:         result V held by each position, (g-1)/g of it received
  * reduce-scatter:     result V/g from a V input: (g-1) x result received
  * all-reduce:         ring = reduce-scatter + all-gather: 2 (g-1)/g x V
  * all-to-all:         (g-1)/g of the result crosses links
  * collective-permute: the whole result is received

The port's all-gather receives every other position's piece whole, and its
pieces are equal (a model-sharded conv has M % model == 0), so (g-1)/g of
the result is exactly what arrives. Its halos are point-to-point copies of
only the rows the window reads from each neighbour: collective-permute,
whose factor 1 is then exact. GSPMD shows some of its halos as pairwise
all-gathers (g = 2, whole neighbour bands) beside its permutes; an all-gather's
factor would assume equal whole pieces, which the port's uneven slabs and
partial bands are not. The heads' gather onto one position is no all-gather
either (only the first position receives), so it is recorded as the
point-to-point copies it is.

The positions of a mesh need not move the same bytes (an edge slab has one
neighbour, a middle slab two; only the first position collects the heads),
so :func:`measure_mesh_comm` reports the position with the most wire bytes,
the one that sets the pace.

The projection (:func:`project_throughput`) is JAX's two-resource roofline:
per-image compute time scales 1/N off one position's measured ms per image,
per-image communication time is wire bytes over the link bandwidth, with
perfect overlap (max) and none (sum). The link bandwidth is an argument:
:data:`NVLINK_BW_H100_SXM` is NVIDIA's published figure, not a measurement.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import defaultdict
from typing import NamedTuple

# NVIDIA's published NVLink bandwidth of the H100 SXM: 900 GB/s with both
# directions together, so 450e9 bytes/s received per GPU. A published figure,
# not a measurement: the machine the port is measured on has one H100.
NVLINK_BW_H100_SXM = 450e9


class Entry(NamedTuple):
    """One recorded collective at one receiving position."""
    op: str            # JAX's op class: all-gather, collective-permute
    what: str          # gather, halo, scatter, collect, handoff
    position: tuple    # the receiving position (pp: stage first)
    nbytes: int        # bytes the collective materialises there
    group: int         # participant count
    layer: int         # the layer whose output crosses (-1: the input)


class CommLog:
    """The entries of a recorded run. ``prefix`` is put before every
    recorded position (:func:`within`: ``pp`` sets it to the stage, and a
    replica's index in front, while a stage runs)."""

    def __init__(self):
        self.entries: list = []
        self.prefix: tuple = ()

    def add(self, op: str, what: str, position: tuple, nbytes: int,
            group: int, layer: int) -> None:
        if nbytes:
            self.entries.append(Entry(op, what, self.prefix + tuple(position),
                                      int(nbytes), int(group), int(layer)))

    def point(self, what: str, position: tuple, tensor, layer: int) -> None:
        """A point-to-point copy of ``tensor`` to ``position``."""
        self.add("collective-permute", what, position, nbytes(tensor), 2,
                 layer)


# the CommLog being filled in this thread's context, or None: recording off
_LOG: contextvars.ContextVar = contextvars.ContextVar("comm_log",
                                                      default=None)


def current():
    """The log being filled, or None."""
    return _LOG.get()


@contextlib.contextmanager
def recording():
    """Record every collective of the multi-device axes run inside (in this
    thread) into a new :class:`CommLog`, which it yields."""
    log = CommLog()
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


@contextlib.contextmanager
def within(*prefix):
    """Positions recorded inside get ``prefix`` in front (after the current
    one); nothing when recording is off."""
    log = _LOG.get()
    if log is None:
        yield
        return
    saved = log.prefix
    log.prefix = saved + prefix
    try:
        yield
    finally:
        log.prefix = saved


def nbytes(t) -> int:
    """Bytes of a tensor in its own dtype (an int8 tensor 1 an element)."""
    return t.numel() * t.element_size()


def positions(log: CommLog) -> list:
    """Every position that received something, in order."""
    return sorted({e.position for e in log.entries})


def collective_volumes(log: CommLog, position: tuple) -> dict:
    """Per-op-class {op: {"count": int, "result_bytes": int, "group_bytes":
    {group size: bytes}}} of the entries received at ``position``: the JAX
    function's dict for one device, from the recorder's log."""
    out: dict = defaultdict(lambda: {"count": 0, "result_bytes": 0,
                                     "group_bytes": defaultdict(int)})
    for e in log.entries:
        if e.position != position:
            continue
        rec = out[e.op]
        rec["count"] += 1
        rec["result_bytes"] += e.nbytes
        rec["group_bytes"][e.group] += e.nbytes
    return {op: {**rec, "group_bytes": dict(rec["group_bytes"])}
            for op, rec in out.items()}


def wire_bytes(volumes: dict, n: int) -> float:
    """Per-device traffic (bytes received per program execution) from the
    result-byte inventory, with the ring factors from the module docstring.
    Each collective's ring factor uses ITS participant count (the
    ``group_bytes`` bucket), falling back to ``n`` for buckets without one;
    a group of one crosses nothing."""
    total = 0.0
    for op, rec in volumes.items():
        buckets = rec.get("group_bytes") or {None: rec["result_bytes"]}
        for g, v in buckets.items():
            g = g or n
            if g <= 1 and op != "collective-permute":
                continue          # single-participant group: nothing crosses
            if op == "all-gather":
                total += v * (g - 1) / g
            elif op == "reduce-scatter":
                total += v * (g - 1)
            elif op == "all-reduce":
                total += 2 * v * (g - 1) / g
            elif op == "all-to-all":
                total += v * (g - 1) / g
            elif op == "collective-permute":
                total += v
    return total


def pacing_position(log: CommLog, n: int):
    """The position with the most wire bytes (the first of equals), or None
    where nothing crossed."""
    best, most = None, -1.0
    for p in positions(log):
        w = wire_bytes(collective_volumes(log, p), n)
        if w > most:
            best, most = p, w
    return best


def mesh_volumes(log: CommLog, mesh, batch: int) -> tuple:
    """(volumes, wire bytes per image) of the pacing position of a recorded
    run of ``mesh`` at global batch ``batch``: its wire bytes over the
    images one position runs, ``batch // data``."""
    p = pacing_position(log, mesh.size)
    vols = {} if p is None else collective_volumes(log, p)
    images_per_position = max(1, batch // mesh.shape["data"])
    return vols, wire_bytes(vols, mesh.size) / images_per_position


def measure_mesh_comm(spec, params, mesh, *, mode="fp32", batch=1,
                      compute_dtype=None, **kw):
    """Run the sharded forward once on zeros with the recorder on, on the
    mesh's own positions, and return (volumes, wire_bytes_per_image) of
    the position with the most wire bytes, the one that sets the pace (the
    positions differ: edge and middle slabs, the first position's collect).
    ``batch`` is the GLOBAL batch; a position runs ``batch // data`` images,
    and its wire bytes are normalised by those. ``params``: the host params
    of ``apps/detect.build_params``; ``kw``: ``make_sharded_predict``'s."""
    import numpy as np
    import torch

    from .mesh import make_sharded_predict

    cd = torch.float32 if compute_dtype is None else compute_dtype
    fn, sharded = make_sharded_predict(spec, params, mesh, mode,
                                       compute_dtype=cd, **kw)
    x = np.zeros((batch, spec.net.h, spec.net.w, spec.net.c), np.float32)
    with recording() as log:
        fn(sharded, x)
    return mesh_volumes(log, mesh, batch)


def pp_boundary_bytes(spec, ranges, dtype_bytes=4) -> list:
    """Analytic pp handoff volume per stage boundary, PER IMAGE
    (microbatch=1): bytes of every live tensor crossing the boundary — the
    running activation plus route/shortcut carries, exactly
    ``parallel.pp.carried_for_boundary``'s liveness set."""
    from .pp import carried_for_boundary

    out = []
    for s in range(len(ranges) - 1):
        stop = ranges[s][1]
        total = 0
        for idx in sorted(carried_for_boundary(spec, stop)):
            l = spec.layers[idx]
            total += l.out_h * l.out_w * l.out_c * dtype_bytes
        out.append(total)
    return out


def project_throughput(single_ms_img: float, per_image_wire: dict,
                       link_bw: float) -> list:
    """Roofline projection rows: for each (axis, N) -> per-image wire bytes,
    return dicts with compute/comm ms and projected img/s (overlap and
    no-overlap). ``per_image_wire`` maps (label, n_devices) -> bytes/image;
    ``single_ms_img``: one position's ms per image; ``link_bw``: bytes/s
    one device receives."""
    rows = []
    for (label, n), bytes_img in sorted(per_image_wire.items(),
                                        key=lambda kv: (kv[0][0], kv[0][1])):
        t_comp = single_ms_img / n
        t_comm = bytes_img / link_bw * 1e3
        overlap = 1e3 / max(t_comp, t_comm)
        serial = 1e3 / (t_comp + t_comm)
        rows.append({
            "mesh": label, "chips": n,
            "wire_mb_img": bytes_img / 1e6,
            "compute_ms_img": t_comp, "comm_ms_img": t_comm,
            "img_s_overlap": overlap, "img_s_serial": serial,
            "comm_bound": t_comm > t_comp,
        })
    return rows


def scaling_rows(wire: dict, pp_bytes: dict, anchors: dict,
                 link_bw: float) -> list:
    """The projected-scaling table's rows, as the JAX package's
    ``scripts/commvol_table.py`` builds them: ``wire`` maps (axis label,
    positions) -> wire bytes per image of a recorded mesh (tp, sp, dp);
    ``pp_bytes`` maps a stage count -> :func:`pp_boundary_bytes` (the
    wavefront's throughput is 1/max(stage), the slowest boundary's handoff
    overlapped); ``anchors`` maps a label -> one position's ms per image.
    Sorted by (label, positions)."""
    rows = []
    for key, per_img in wire.items():
        rows += project_throughput(anchors[key[0]], {key: per_img}, link_bw)
    for n, bb in pp_bytes.items():
        t_comp = anchors["pp"] / n
        t_comm = max(bb) / link_bw * 1e3
        rows.append({"mesh": "pp", "chips": n, "wire_mb_img": sum(bb) / 1e6,
                     "compute_ms_img": t_comp, "comm_ms_img": t_comm,
                     "img_s_overlap": 1e3 / max(t_comp, t_comm),
                     "img_s_serial": 1e3 / (t_comp + t_comm),
                     "comm_bound": t_comm > t_comp})
    return sorted(rows, key=lambda r: (r["mesh"], r["chips"]))


def table_markdown(rows: list) -> str:
    """The rows as the JAX script's markdown table (link, not ICI)."""
    lines = ["| mesh | positions | wire MB/img | compute ms | link ms | "
             "proj img/s (overlap) | proj img/s (serial) | bound |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['mesh']} | {r['chips']} | {r['wire_mb_img']:.2f} | "
            f"{r['compute_ms_img']:.3f} | {r['comm_ms_img']:.3f} | "
            f"{r['img_s_overlap']:.0f} | {r['img_s_serial']:.0f} | "
            f"{'link' if r['comm_bound'] else 'compute'} |")
    return "\n".join(lines)

