"""Pipeline parallelism: the network split into layer stages across device
positions, with microbatches in a GPipe wavefront.

Counterpart of ``yolo2_light_tpu/parallel/pp.py``. The network splits into
``n_stages`` contiguous, BFLOPs-balanced layer ranges; each stage's params
live on its own device, and microbatches flow through the stages in a
wavefront: while stage s computes microbatch m, stage s-1 computes m+1.
JAX's async dispatch gives that overlap; here each stage is a position with
a CUDA stream of its own (``parallel/mesh.Position``), every stage step is
issued on its stage's stream, and a hand-over between stages is a copy to
the next stage's device (``.to(dev, non_blocking=True)``) or, where the
stages share a device, the same tensor with the next stage's stream waiting
on the producing one (``mesh.handoff``, which also keeps the caching
allocator from reusing the block while the reader may still run). The one
Python thread only defines the order; on the CPU the same order runs
serially.

A stage boundary needs no halo or replication logic: ``build_forward``'s
``layer_range``/``carried`` run a contiguous range given the outputs of
earlier layers that it reads, and the split carries only the tensors a later
route or shortcut reads (:func:`carried_for_boundary`). Every hand-over
between stages or replicas reports what it moves to ``commvol``'s recorder
when that is on.
"""

from __future__ import annotations

import torch

from ..cfg import ConvSpec, ModelSpec, RegionSpec, YoloSpec
from ..models.network import (HeadOutput, _consumers, build_forward,
                              device_params, load_kernels)
from . import commvol
from .mesh import (Mesh, Position, ShardedForward, cuda_devices, handoff,
                   join, shard_params)


def _bflops(l) -> float:
    if isinstance(l, ConvSpec):
        return l.bflops
    return 0.0


def split_stages(spec: ModelSpec, n_stages: int) -> list:
    """Contiguous layer ranges [(start, stop), ...], BFLOPs-balanced: stage s
    ends at the first layer where cumulative cost reaches (s+1)/n of total."""
    total = sum(_bflops(l) for l in spec.layers) or float(spec.n)
    bounds = []
    acc = 0.0
    start = 0
    for l in spec.layers:
        acc += _bflops(l) if total != float(spec.n) else 1.0
        if (len(bounds) < n_stages - 1
                and acc >= total * (len(bounds) + 1) / n_stages
                and l.index + 1 < spec.n):
            bounds.append((start, l.index + 1))
            start = l.index + 1
    bounds.append((start, spec.n))
    return bounds


def carried_for_boundary(spec: ModelSpec, stop: int) -> set:
    """Layer indices < stop whose outputs some layer >= stop still reads
    (routes/shortcuts/sequential-successor)."""
    consumers = _consumers(spec)
    return {j for j in range(stop) if any(c >= stop for c in consumers[j])}


def default_devices(need: int, device="cuda") -> list:
    """The devices of a pipeline that is given none: ``cuda:0 ..`` (all the
    machine has; the caller checks the count), or ``need`` times the CPU."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * need
    return cuda_devices()


class PipelinedPredictor:
    """Stage-split predictor: ``__call__(x[B]) -> (heads, aux)``.

    Bit-identical to the single-device forward at the same microbatch size,
    in every mode: a stage boundary adds no numerics, and the only cross-stage
    effect, dropped int8 producer-chaining, is bit-identical to consumer-side
    quantization (the port's kernels do not change with the program around
    them, so the JAX package's FMA-contraction caveat does not arise).
    ``turbo="int8"`` materializes no trunk tensor whose target lies in a
    later stage, as in the JAX package.

    ``devices``: one per stage (``n_stages * tp`` with ``tp > 1``, ``tp`` a
    stage), a list that may repeat a device; by default ``cuda:0 ..`` for
    ``device`` "cuda" (fewer than needed raises) or the CPU for "cpu".
    ``microbatch``: rows per pipeline step (B must divide evenly). ``tp``:
    tensor-parallel width within each stage: every stage is then a 1 x 1 x
    tp :class:`mesh.Mesh` run by ``mesh.ShardedForward`` (its convs sharded
    over output channels as ``mesh.shard_params`` shards them). ``params``:
    the host params of ``apps/detect.build_params``. The other keywords are
    ``build_forward``'s.
    """

    def __init__(self, spec: ModelSpec, params: list, mode: str = "fp32", *,
                 n_stages: int = 2, microbatch: int = 1, devices=None,
                 int8_policy: str = "cpu", compute_dtype=torch.float32,
                 xnor_impl: str = "int8", int8_impl: str = "xla",
                 turbo=False, tp: int = 1, device="cuda"):
        if mode == "int8" and int8_policy == "cpu_old":
            raise ValueError(
                "-pp: pipeline stages need a layer range, and the legacy "
                "int8 chain of -int8_policy cpu_old runs as one forward")
        self.spec = spec
        self.n_stages = n_stages
        self.microbatch = microbatch
        self.tp = tp
        need = n_stages * tp
        devs = (list(devices) if devices is not None
                else default_devices(need, device))
        if len(devs) < need:
            raise ValueError(f"need {need} devices, have {len(devs)}")
        self.devices = [torch.device(d) for d in devs[:need]]
        self.ranges = split_stages(spec, n_stages)
        self.carried_sets = [carried_for_boundary(spec, stop)
                             for (_s, stop) in self.ranges[:-1]] + [set()]
        consumers = _consumers(spec)
        self._needed = [
            {j for j in range(a) if any(c >= a for c in consumers[j])}
            for (a, _b) in self.ranges]
        kw = dict(int8_policy=int8_policy, compute_dtype=compute_dtype,
                  xnor_impl=xnor_impl, int8_impl=int8_impl, turbo=turbo)
        convert = dict(int8_policy=int8_policy, xnor_impl=xnor_impl,
                       compute_dtype=compute_dtype)
        # per stage: only that stage's layer entries, on its device(s)
        self.positions, self.stage_params, self.stage_fns = [], [], []
        for s, (a, b) in enumerate(self.ranges):
            own = [p if a <= i < b else None for i, p in enumerate(params)]
            if tp > 1:
                mesh = Mesh(self.devices[s * tp:(s + 1) * tp], model=tp)
                self.positions.append(mesh.positions[0])
                self.stage_params.append(shard_params(
                    spec, device_params(spec, own, mode, "cpu", **convert),
                    mesh))
                self.stage_fns.append(ShardedForward(
                    spec, mesh, mode, layer_range=(a, b),
                    carry_out=self.carried_sets[s], **kw))
                continue
            pos = Position((s,), self.devices[s])
            self.positions.append(pos)
            self.stage_params.append(
                device_params(spec, own, mode, pos.device, **convert))
            self.stage_fns.append(build_forward(
                spec, mode, layer_range=(a, b),
                carry_out=self.carried_sets[s], **kw))
        if any(d.type == "cuda" for d in self.devices):
            load_kernels(spec, mode, **convert, int8_impl=int8_impl)
        self.stage_head_meta = [
            [(l.index, "yolo" if isinstance(l, YoloSpec) else "region")
             for l in spec.layers[a:b]
             if isinstance(l, (YoloSpec, RegionSpec))]
            for a, b in self.ranges]

    def __call__(self, x):
        x = torch.as_tensor(x)
        if x.is_floating_point():
            x = x.to(torch.float32)
        # dense NHWC strides (a NumPy batch of one may have a batch stride
        # of 0, which cuDNN does not read as channels-last)
        x = x.reshape(-1).view(x.shape)
        B = x.shape[0]
        mb = self.microbatch
        if B % mb:
            raise ValueError(f"batch {B} not divisible by microbatch {mb}")
        M = B // mb
        n = self.n_stages
        caller = Position.current(x.device)
        log = commvol.current()
        # wavefront schedule: at step k, stage s works on microbatch k-s.
        # Every step is issued on its stage's stream without waiting, so
        # the stages overlap in time.
        cur = [None] * M            # (running activation, its position)
        carried = [dict() for _ in range(M)]   # j -> (output, position)
        head_datas = [[] for _ in range(M)]    # (head map, position)
        with torch.inference_mode():
            for k in range(M + n - 1):
                for s in range(min(k, n - 1), -1, -1):
                    m = k - s
                    if m < 0 or m >= M:
                        continue
                    pos = self.positions[s]
                    if s == 0:
                        xin = handoff(x[m * mb:(m + 1) * mb], caller, pos)
                    else:
                        xin = handoff(*cur[m], pos)
                        if log is not None:
                            log.point("handoff", self._where(s), xin,
                                      self.ranges[s][0] - 1)
                    car = {}
                    for j, (v, src) in carried[m].items():
                        if j not in self._needed[s]:
                            continue
                        if s > 0 and v is cur[m][0]:
                            car[j] = xin    # the running activation, once
                            continue
                        car[j] = handoff(v, src, pos)
                        if log is not None:
                            log.point("handoff", self._where(s), v, j)
                    with pos.scope(), commvol.within(s):
                        heads, aux = self.stage_fns[s](
                            self.stage_params[s], xin, car)
                    cur[m] = (aux["final"], pos)
                    carried[m].update({j: (v, pos)
                                       for j, v in aux["outputs"].items()})
                    head_datas[m].extend((h.data, pos) for h in heads)
            # reassemble full-batch heads in head order (concat microbatches)
            # on the last stage
            meta = [hm for metas in self.stage_head_meta for hm in metas]
            last = self.positions[-1]
            out = []
            for hi, (idx, kind) in enumerate(meta):
                parts = []
                for m in range(M):
                    data, pos = head_datas[m][hi]
                    parts.append(handoff(data, pos, last))
                    if log is not None and pos is not last:
                        log.point("collect", self._where(n - 1), data, idx)
                with last.scope():
                    data = parts[0] if M == 1 else torch.cat(parts, dim=0)
                out.append(HeadOutput(idx, kind, data))
            finals = [handoff(*c, last) for c in cur]
            join([h.data for h in out] + finals, last)
        return tuple(out), {"final": finals}

    def _where(self, s: int) -> tuple:
        """The recorder's name of stage ``s``'s first position."""
        return (s,) if self.tp == 1 else (s, 0, 0, 0)

    def head_specs(self):
        return [l for l in self.spec.layers
                if isinstance(l, (YoloSpec, RegionSpec))]


class ReplicatedPipeline:
    """Data-parallel pipeline replicas: dp x pp (x tp). ``replicas``
    independent :class:`PipelinedPredictor` copies each own
    ``n_stages * tp`` devices; a batch splits evenly across replicas, and
    every replica's wavefront is issued before any result is read, so the R
    wavefronts interleave on their streams with no cross-replica
    communication. Bit-identical to a single PipelinedPredictor at the same
    microbatch size: each replica runs the same stage programs on its batch
    shard."""

    def __init__(self, spec: ModelSpec, params: list, mode: str = "fp32", *,
                 replicas: int = 2, n_stages: int = 2, microbatch: int = 1,
                 devices=None, tp: int = 1, device="cuda", **kw):
        per = n_stages * tp
        need = replicas * per
        devs = (list(devices) if devices is not None
                else default_devices(need, device))
        if len(devs) < need:
            raise ValueError(f"need {need} devices "
                             f"({replicas} replicas x {n_stages} stages x "
                             f"tp {tp}), have {len(devs)}")
        self.spec = spec
        self.replicas = [
            PipelinedPredictor(spec, params, mode, n_stages=n_stages,
                               microbatch=microbatch,
                               devices=devs[r * per:(r + 1) * per], tp=tp,
                               **kw)
            for r in range(replicas)]
        self.ranges = self.replicas[0].ranges

    def __call__(self, x):
        x = torch.as_tensor(x)
        B, R = x.shape[0], len(self.replicas)
        if B % R:
            raise ValueError(f"batch {B} not divisible by {R} replicas")
        sh = B // R
        log = commvol.current()
        # all replicas dispatch before any result is read: the R wavefronts
        # overlap across their streams. The caller stands where the first
        # replica's first stage is.
        outs = []
        for r, rep in enumerate(self.replicas):
            xr = x[r * sh:(r + 1) * sh]
            with commvol.within(r):
                if log is not None and r > 0:
                    log.point("scatter", rep._where(0), xr, -1)
                outs.append(rep(xr))
        first = self.replicas[0]
        anchor = first.positions[-1].device
        heads = []
        with torch.inference_mode():
            for hi, h0 in enumerate(outs[0][0]):
                data = torch.cat([o[0][hi].data.to(anchor, non_blocking=True)
                                  for o in outs], dim=0)
                heads.append(HeadOutput(h0.index, h0.kind, data))
                if log is not None:
                    for o in outs[1:]:
                        log.point("collect",
                                  (0,) + first._where(first.n_stages - 1),
                                  o[0][hi].data, h0.index)
        finals = [f for o in outs for f in o[1]["final"]]
        return tuple(heads), {"final": finals}

    def head_specs(self):
        return self.replicas[0].head_specs()
