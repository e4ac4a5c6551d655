"""Fused frame->boxes serving pipeline: (optional YUV or uint8 ingest and
resize) + network forward + on-device decode/compaction (+ optionally exact
greedy NMS, ``device_nms=True``) as ONE captured CUDA graph per input
signature; the host does only exact NMS (or, with device NMS, none) and
formatting over <=K candidates.

Counterpart of ``yolo2_light_tpu/pipeline.py``, whose ``jax.jit(run)`` is
this module's CUDA graph: on the card, :meth:`DetectionPipeline.raw`
captures ``run`` once per (shape, dtype) of its input into a
``torch.cuda.CUDAGraph`` with a static input buffer, after warming it up
eagerly on a side stream (kernel builds, the kernels' one-time function
attributes, cuDNN's algorithm choice), and then replays it: one launch for
the whole network, decode and NMS. All graphs of a pipeline share one memory
pool. On the CPU ``run`` stays eager.

Transfers: inputs ship as uint8 (or planar YUV420, half of that) and are
normalized on the device; the device returns ONE packed [K, 4+1+classes]
candidate buffer per image instead of full head maps. On the graph path a
transfer that would wait behind a replay it does not need runs on a copy
stream of the pipeline's own, ordered against the replays by CUDA events: a
batch's H2D, where the replays' stream is busy, runs while the replay
dispatched before it runs, and a collect's D2H, where a later dispatch
followed, waits for its own replay only, so the host finish of a batch runs
while the next replay does. In a closed loop both stay on the replays'
stream, which is then idle or holds the request's own replay.

Under a device mesh (``mesh=``, ``parallel/mesh.py``) or pipeline stages
(``pp_stages > 1``, ``parallel/pp.py``) the program runs eagerly across the
positions' streams (one graph across positions is not captured yet): each
``data`` position ingests its images, or stage 0's device ingests the batch,
and decode and NMS run on the first position's (the last stage's) device
after the heads are gathered there.

Tracing (``utils/profiling.py``): while a ``torch.profiler`` session is
active, each request records its spans (``dispatch`` with ``dispatch.h2d``
and ``dispatch.replay``, which holds ``trace.wait``; ``collect`` with
``collect.wait``, ``collect.d2h``, ``collect.saturated``,
``collect.regrow``, ``collect.finish`` and its ``finish.nms``), its
counters (``images``, ``candidates``, ``h2d_bytes``; on the graph path
``overlapped``: 1 where a later replay of the pipeline was still on the
device as the finish began, else 0) and the device ms of each stage
(:data:`STAGES`) of each replay, from events captured at the stage bounds
in a graph of its own; the graphs replayed untraced hold no such events.
Where the net has an ``[upsample]``, one more event splits the network
stage after the last layer before the first of them (:data:`SPLIT`: the
backbone's way down, then the way back up to the heads). Each hook tests
``profiling.REC`` once.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import torch

from .cfg import ModelSpec, RegionSpec, UpsampleSpec, YoloSpec
from .models.network import build_forward, device_params, load_kernels
from .ops.resize import Resizer
from .post import boxes as post
from .post.device_decode import Decoder
from .post.device_nms import load_kernels as load_nms_kernels
from .post.device_nms import nms_packed
from .utils import profiling

# eager runs on a side stream before a capture (PyTorch's recipe)
_WARMUP_RUNS = 2

# the device program's stages, between the events of a traced graph
STAGES = ("ingest", "network", "decode", "nms")
# the network stage's two parts, on either side of its split event
SPLIT = ("network.down", "network.up")


def _fetch_packed(raw: torch.Tensor) -> np.ndarray:
    """D2H fetch of a packed candidate buffer, as ONE host transfer."""
    return raw.cpu().numpy()


def yuv420_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """Planar YUV420 (I420) [B, H*3/2, W] uint8 -> RGB f32 [B,H,W,3] in [0,1].

    BT.601 full-range conversion on the device; U/V planes are
    nearest-upsampled 2x. Half the host->device bytes of uint8 RGB."""
    b, h32, w = x.shape
    h = (h32 * 2) // 3
    y = x[:, :h, :].to(torch.float32)
    u = x[:, h: h + h // 4, :].reshape(b, h // 2, w // 2).to(torch.float32)
    v = x[:, h + h // 4:, :].reshape(b, h // 2, w // 2).to(torch.float32)
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    bch = y + 1.772 * u
    rgb = torch.stack([r, g, bch], dim=-1)
    return torch.clamp(rgb, 0.0, 255.0) * (1.0 / 255.0)


def _as_input(images) -> torch.Tensor:
    """A batch as a tensor: NumPy arrays are wrapped (no copy where they are
    contiguous with nonnegative strides); float64 becomes float32."""
    if not isinstance(images, torch.Tensor):
        a = np.ascontiguousarray(images)
        # NumPy calls a reversed size-1 axis contiguous; torch refuses it
        images = torch.from_numpy(a if min(a.strides, default=0) >= 0
                                  else a.copy())
    x = images
    if x.is_floating_point() and x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x


def _source_sizes(shape, spec: ModelSpec):
    """Default ``im_sizes`` of a batch of ``shape``: device-resized source
    frames correct back to the SOURCE dims, matching the reference's
    im.w/im.h arguments (src/main.c:222); net-size frames need none."""
    if len(shape) == 3:                       # planar YUV420 [B,H*3/2,W]
        sw, sh = shape[2], shape[1] * 2 // 3
    else:
        sw, sh = shape[2], shape[1]
    if (sw, sh) != (spec.net.w, spec.net.h):
        return [(sw, sh)] * shape[0]
    return None


def _split_layer(spec: ModelSpec):
    """The last layer before the net's first ``[upsample]``, or None where
    it has none (or the upsample comes first)."""
    first = next((l.index for l in spec.layers
                  if isinstance(l, UpsampleSpec)), 0)
    return first - 1 if first > 0 else None


class _Graph:
    """One captured ``run``: its graph and static input and output; a graph
    captured while tracing also holds the events at its stage bounds (and
    its split event, last) and the (request, host ns) of the replay whose
    times they hold unread."""

    def __init__(self, graph, static_in, static_out, stages=None):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.stages = stages
        self.unread = None


class DetectionPipeline:
    """End-to-end detector: ``__call__(images) -> list[Detections]``.

    ``images``: [B,H,W,C] uint8 (preferred, [0,255]) or float32 in [0,1], or
    planar YUV420 [B, H*3/2, W] uint8. Frames whose spatial dims differ from
    the net's are resized ON DEVICE with the darknet-exact bilinear
    (ops/resize.py); all frames of a batch share one source size, and each
    source size has its own graph.

    ``device_nms=True`` fuses exact greedy NMS (post/device_nms.py) into the
    graph: the packed buffer arrives pre-suppressed and the host skips
    ``do_nms_sort`` — same detections, no host post-processing beyond
    coordinate correction and formatting.

    ``device``: ``"cuda"`` (default; raises where CUDA is missing) or
    ``"cpu"``, which runs every kernel's plain version. ``cuda_graph=False``
    runs ``run`` eagerly on the card too (the graph's reference); a ``mesh``
    or ``pp_stages > 1`` runs it eagerly always. ``mesh``: a
    ``parallel.mesh.Mesh`` (its positions' devices replace ``device``); the
    batch must divide by its ``data`` axis (``data_parallel``). ``pp_stages``,
    ``pp_microbatch`` and ``pp_tp``: ``parallel.pp.PipelinedPredictor``'s
    stages, microbatch and tensor-parallel width, on ``pp_devices`` (a list
    that may repeat a device) or else ``device``'s kind; not together with a
    mesh. ``params``:
    the per-layer host params of ``apps/detect.build_params``, or the
    converted params of another pipeline on the same device (converted for
    the same ``compute_dtype``). ``compute_dtype``, ``turbo`` and
    ``int8_chain`` are ``network.build_forward``'s precision modes; the
    captured graph holds in each (the heads, and so the packed buffer, are
    float32 in every mode).
    """

    def __init__(self, spec: ModelSpec, params: list, mode: str = "fp32", *,
                 thresh: float = 0.24, nms: float = 0.4, k: int = 256,
                 int8_policy: str = "cpu", compute_dtype=torch.float32,
                 letter: bool = False, xnor_impl: str = "int8", mesh=None,
                 device_nms: bool = False, turbo=False, int8_impl: str = "xla",
                 pp_stages: int = 0, pp_microbatch: int = 1, pp_tp: int = 1,
                 device="cuda", cuda_graph: bool = True,
                 int8_chain: bool = True, pp_devices=None, _parallel=None):
        if pp_stages > 1 and mesh is not None:
            raise ValueError("pp_stages and mesh are mutually exclusive "
                             "(pipeline stages own whole devices)")
        if mesh is not None:
            device = mesh.positions[0].device
        self.spec = spec
        self.thresh = thresh
        self.nms = nms
        self.k = k
        self.letter = letter
        self.device_nms = bool(device_nms and nms)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (use device='cpu' to "
                               "run the plain PyTorch path)")
        self._mode = mode
        self._int8_policy = int8_policy
        self._xnor_impl = xnor_impl
        self._int8_impl = int8_impl
        self._compute_dtype = compute_dtype
        self._turbo = turbo
        self._int8_chain = int8_chain
        self._mesh = mesh
        self._pp_stages = int(pp_stages)
        self._pp_microbatch = int(pp_microbatch)
        self._pp_tp = max(1, int(pp_tp))
        self._cuda_graph = (cuda_graph and self.device.type == "cuda"
                            and mesh is None and pp_stages <= 1)
        self._grow_lock = threading.Lock()
        self._run_lock = threading.Lock()
        self._stage_lock = threading.Lock()
        kw = dict(int8_policy=int8_policy, xnor_impl=xnor_impl,
                  int8_impl=int8_impl, compute_dtype=compute_dtype,
                  turbo=turbo)
        convert = dict(int8_policy=int8_policy, xnor_impl=xnor_impl,
                       compute_dtype=compute_dtype)
        # the parallel engines; a grown pipeline shares its parent's, and
        # its params as the parent holds them
        self._pp, self._sharded = _parallel or (None, None)
        if self._pp is not None or self._sharded is not None:
            self.params = params
        elif pp_stages > 1:
            from .parallel.pp import PipelinedPredictor
            self._pp = PipelinedPredictor(
                spec, params, mode, n_stages=pp_stages,
                microbatch=max(1, pp_microbatch), tp=self._pp_tp,
                devices=pp_devices, device=self.device, **kw)
            self.params = params
        elif mesh is not None:
            from .parallel.mesh import ShardedForward, shard_params
            self._sharded = ShardedForward(spec, mesh, mode,
                                           int8_chain=int8_chain, **kw)
            self.params = shard_params(
                spec, params if _converted(params)
                else device_params(spec, params, mode, "cpu", **convert),
                mesh)
        else:
            self._fwd_kw = dict(int8_chain=int8_chain, **kw)
            self._fwd = build_forward(spec, mode, **self._fwd_kw)
            self.params = (params if _converted(params)
                           else device_params(spec, params, mode,
                                              self.device, **convert))
        if self._pp is not None:
            # the heads, and so decode and NMS, end on the last stage
            self.device = self._pp.positions[-1].device
        self.data_parallel = mesh.shape["data"] if mesh is not None else 1
        self.head_specs = [l for l in spec.layers
                           if isinstance(l, (YoloSpec, RegionSpec))]
        self.classes = self.head_specs[-1].classes
        # total raw candidates the net can produce (sum over heads of
        # h*w*anchors): the top-k clamps to this N, so K >= N cannot drop a
        # detection — it is the saturation auto-grow ceiling. device_nms
        # keeps a 4096 cap: its per-image [K,K] IoU matrix is O(K^2) memory.
        self._total_candidates = sum(l.out_h * l.out_w * l.n
                                     for l in self.head_specs)
        # both paths build the buffer in DECODE order (the reference NMS's
        # tie-break order): the host path runs do_nms_sort over it; device
        # NMS seeds its carried-qsort permutation from it and returns rows
        # already permuted to the reference's POST-NMS order
        self._decoder = Decoder(
            self.head_specs, [(None, l.out_h, l.out_w, l.n, None)
                              for l in self.head_specs],
            spec.net.w, spec.net.h, thresh, k, self.device, decode_order=True)
        self._255: dict = {}
        self._resizers: dict = {}
        self._graphs: dict = {}
        self._serve_out: dict = {}
        self._pool = None
        self._promoted = None
        self._grown_cache = None
        # the graph path's transfers, and the done event of its last dispatch
        self._copy = None
        self._last_done = None
        if self.device.type == "cuda":
            load_kernels(spec, mode, int8_policy=int8_policy,
                         int8_impl=int8_impl, xnor_impl=xnor_impl,
                         compute_dtype=compute_dtype)
            if self.device_nms:
                load_nms_kernels(self.device)
            if self._cuda_graph:
                self._pool = torch.cuda.graph_pool_handle()
                self._copy = torch.cuda.Stream(self.device)

    # ---- the program ----------------------------------------------------

    def _resizer(self, ih: int, iw: int, device) -> Resizer:
        r = self._resizers.get((ih, iw, device))
        if r is None:
            r = Resizer(ih, iw, self.spec.net.h, self.spec.net.w, device)
            self._resizers[(ih, iw, device)] = r
        return r

    def ingest(self, x: torch.Tensor) -> torch.Tensor:
        """Device input -> [B, net_h, net_w, 3] f32 in [0, 1]."""
        if x.dim() == 3:
            # planar YUV420 ingest [B, H*3/2, W] uint8: BT.601 on the device
            x = yuv420_to_rgb(x)
        if x.dtype == torch.uint8:
            # /255 as the host loader and the reference divide
            # (load_image_stb), by a device tensor (ROADMAP F9)
            c = self._255.get(x.device)
            if c is None:
                c = self._255[x.device] = torch.tensor(
                    255.0, dtype=torch.float32, device=x.device)
            x = x.to(torch.float32) / c
        if x.shape[1] != self.spec.net.h or x.shape[2] != self.spec.net.w:
            # source-resolution frames: darknet-exact bilinear resize ON
            # DEVICE (the reference resizes every input on the host,
            # src/main.c:188, additionally.c:3021)
            x = self._resizer(x.shape[1], x.shape[2], x.device)(x)
        return x

    def post(self, head_datas, stages=None) -> torch.Tensor:
        """Head maps -> the packed [B, K(+1), 4+1+classes] buffer;
        ``stages``: as :meth:`run`'s."""
        packed = self._decoder.packed(list(head_datas))
        if stages is not None:
            stages[3].record()
        if not self.device_nms:
            if stages is not None:
                stages[4].record()
            return packed
        # suppression zeroes probs, which would hide buffer saturation from
        # the host, so a PRE-NMS saturation FLAG (1.0 iff every slot held a
        # candidate) rides along as one extra all-zero row
        score = packed[..., 5:].amax(dim=-1)
        if packed.shape[1] == self.k:
            saturated = (score > 0).all(dim=-1)
        else:
            # the buffer holds EVERY decoded candidate (total N < k)
            saturated = torch.zeros(packed.shape[0], dtype=torch.bool,
                                    device=packed.device)
        packed = nms_packed(packed, self.nms)
        extra = torch.zeros((packed.shape[0], 1, packed.shape[2]),
                            dtype=packed.dtype, device=packed.device)
        extra[:, 0, 0] = saturated.to(packed.dtype)
        packed = torch.cat([packed, extra], dim=1)
        if stages is not None:
            stages[4].record()
        return packed

    def run(self, x: torch.Tensor, stages=None) -> torch.Tensor:
        """The whole device program on a batch, eagerly. ``stages``: on one
        device, CUDA events to record before and after each of
        :data:`STAGES` (a traced capture's)."""
        if self._pp is not None:
            # ingest on stage 0's device, decode and NMS on the last's
            x = self.ingest(x.to(self._pp.positions[0].device))
            heads, _ = self._pp(x)
        elif self._sharded is not None:
            # each data position ingests its images
            heads, _ = self._sharded(self.params, x.to(self.device),
                                     prepare=self.ingest)
        elif stages is not None:
            stages[0].record()
            x = self.ingest(x.to(self.device))
            stages[1].record()
            heads, _ = self._split_forward(stages)(self.params, x)
            stages[2].record()
        else:
            heads, _ = self._fwd(self.params, self.ingest(x.to(self.device)))
        return self.post([h.data for h in heads], stages)

    def _split_forward(self, stages):
        """The forward of a traced capture: where ``stages`` holds a split
        event (past the :data:`STAGES` bounds), one that records it after
        the split layer (or, where the fused engine runs that layer inside a
        block, after the block)."""
        if len(stages) == len(STAGES) + 1:
            return self._fwd
        at, marked = _split_layer(self.spec), []

        def mark(i):
            if i >= at and not marked:
                stages[-1].record()
                marked.append(i)
        return build_forward(self.spec, self._mode, layer_hook=mark,
                             **self._fwd_kw)

    def _graph_for(self, x: torch.Tensor) -> _Graph:
        """The graph of ``x``'s signature, captured at its first use
        (``x``: a device batch of that signature, for the warm-up); while
        tracing, the traced graph of that signature."""
        traced = profiling.REC is not None
        key = (tuple(x.shape), x.dtype, traced)
        g = self._graphs.get(key)
        if g is None:
            events = len(STAGES) + 1 + (_split_layer(self.spec) is not None)
            g = self._graphs[key] = self._capture(x, [
                torch.cuda.Event(enable_timing=True, external=True)
                for _ in range(events)] if traced else None)
        return g

    def _capture(self, x: torch.Tensor, stages=None) -> _Graph:
        """Warm ``run`` up on ``x`` and capture it (``stages``: as
        :meth:`run`'s, recorded in the graph)."""
        static_in = torch.empty(x.shape, dtype=x.dtype, device=self.device)
        static_in.copy_(x)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_RUNS):
                self.run(static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            static_out = self.run(static_in, stages)
        return _Graph(graph, static_in, static_out, stages)

    def _replay(self, g: _Graph, x: torch.Tensor, span,
                out=None) -> torch.Tensor:
        """Copy ``x`` into the graph's input, replay, and clone the output
        (the next replay overwrites the static output), or copy it into
        ``out``; inside ``span``, the open ``dispatch.replay``. A traced
        graph's stage times are read first, before the replay records its
        events again, and it keeps the span's request and start for the
        new ones."""
        if g.unread is not None:
            self._read_stages(g, "trace.wait")
        g.static_in.copy_(x)
        g.graph.replay()
        if g.stages is not None:
            g.unread = (span.request, span.start)
        if out is None:
            return g.static_out.clone()
        return out.copy_(g.static_out)

    def _read_stages(self, g: _Graph, wait: str, request=None) -> None:
        """Record the stage times of the replay that ``g``'s events hold
        unread (where ``request`` is given, only if it is that request's),
        waiting for its end inside a span named ``wait``."""
        with self._stage_lock:
            unread = g.unread
            if unread is None or request not in (None, unread[0]):
                return
            g.unread = None
            rec = profiling.REC
            if rec is not None:
                bounds = g.stages[:len(STAGES) + 1]
                inner = (list(zip(SPLIT, (bounds[1], g.stages[-1]),
                                  (g.stages[-1], bounds[2])))
                         if len(g.stages) > len(bounds) else ())
                rec.stages(bounds, STAGES, *unread, wait, inner)

    def _h2d(self, images) -> torch.Tensor:
        """``images`` as a tensor on the device, inside a ``dispatch.h2d``
        span: where the current stream (the replays') still has work, copied
        on the copy stream, which the current stream then waits for."""
        with profiling.span("dispatch.h2d"):
            x = _as_input(images)
            rec = profiling.REC
            if rec is not None and x.device != self.device:
                rec.count("h2d_bytes", x.numel() * x.element_size())
            main = torch.cuda.current_stream(self.device)
            if main.query():
                # nothing to wait behind: the pageable copy blocks the host
                # for itself alone, and crossing streams would only cost
                return x.to(self.device)
            with torch.cuda.stream(self._copy):
                x = x.to(self.device)
            main.wait_stream(self._copy)
            # allocated on the copy stream, read on the replays' stream: its
            # block must not go to the next H2D before that read
            x.record_stream(main)
            return x

    def _done(self) -> torch.cuda.Event:
        """The event after what the current stream holds of the last
        dispatch (its replay and output), kept as the pipeline's latest."""
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._last_done = done
        return done

    def raw(self, images) -> torch.Tensor:
        """Packed device output [B, K(+1), 4+1+classes] — still on the
        device, ordered on the current stream."""
        return self._enqueue(images)[0]

    def _enqueue(self, images):
        """:meth:`raw`, and the event after its replay on the graph path
        (None on the eager paths, where the output is the current
        stream's)."""
        if not self._cuda_graph:
            x = _as_input(images)
            with torch.inference_mode(), self._run_lock:
                return self.run(x), None
        # the H2D touches no static buffer: it needs neither the lock nor
        # inference mode; the replay's span holds both, and the graph's
        # capture at a signature's first use
        x = self._h2d(images)
        with (profiling.span("dispatch.replay") as s, torch.inference_mode(),
              self._run_lock):
            out = self._replay(self._graph_for(x), x, s)
            return out, self._done()

    # ---- batches ----------------------------------------------------------

    def dispatch(self, images):
        """Start a batch: H2D + enqueue the graph. Returns a ticket for
        :meth:`collect`; host work between the two overlaps the device, and
        so does the next dispatch's H2D."""
        if self._promoted is not None:
            return self._promoted.dispatch(images)
        with profiling.span("dispatch") as s:
            return (self, *self._enqueue(images), images, s.request)

    def collect(self, ticket, im_sizes=None):
        """Blocking half of :meth:`dispatch`: one D2H fetch, saturation
        handling (auto-grow re-run of the kept input batch), host finish."""
        pipe, raw_dev, done, images, request = ticket
        if im_sizes is None:
            im_sizes = _source_sizes(tuple(images.shape), pipe.spec)
        return pipe._land(raw_dev, done, im_sizes,
                          lambda grown: grown(images, im_sizes), request)

    def _fetch(self, raw_dev, done) -> np.ndarray:
        """The D2H fetch of ``raw_dev``: where a later dispatch followed its
        replay, on the copy stream after ``done`` (that replay's event) and
        nothing later; else in the current stream's order."""
        if done is None or done is self._last_done:
            return _fetch_packed(raw_dev)
        raw_dev.record_stream(self._copy)
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(done)
            return _fetch_packed(raw_dev)

    def _land(self, raw_dev, done, im_sizes, rerun, request=None):
        """The blocking half of a request (``request``: its id while
        tracing): one D2H fetch of the packed buffer ``raw_dev`` (``done``:
        its replay's event, or None), then, where it saturated, ``rerun`` of
        the grown pipeline (its result is returned), else the host
        finish."""
        with profiling.span("collect", request) as s:
            if s.request is not None:
                # the traced graph's events of this request's replay
                for g in list(self._graphs.values()):
                    if g.unread is not None:
                        self._read_stages(g, "collect.wait", s.request)
            with profiling.span("collect.d2h"):
                packed = self._fetch(raw_dev, done)    # one D2H transfer
            with profiling.span("collect.saturated"):
                regrow = self._saturated(packed) and self.k < self._max_k
            if regrow:
                with profiling.span("collect.regrow"):
                    return rerun(self._grow_and_promote())
            with profiling.span("collect.finish"):
                rec = profiling.REC
                if rec is not None and done is not None:
                    # a later dispatch's replay still on the device
                    later = self._last_done
                    rec.count("overlapped",
                              later is not done and not later.query())
                out = self._finish_batch(packed, im_sizes)
                if rec is not None:
                    rec.count("images", len(out))
                    rec.count("candidates", sum(d.n for d in out))
            return out

    @property
    def _max_k(self) -> int:
        """Auto-grow ceiling: the net's total candidate count (K >= N cannot
        drop anything), bounded at 4096 under device_nms (the JAX package's
        ceiling; the overlap bits take K*K/8 bytes an image)."""
        return (min(4096, self._total_candidates) if self.device_nms
                else self._total_candidates)

    def _saturated(self, packed: np.ndarray) -> bool:
        """True when this pipeline's candidate buffer filled for any image of
        an already-fetched packed batch (detections may have been dropped)."""
        if self.k >= self._total_candidates:
            # K covers every decodable candidate: nothing can be dropped
            return False
        rows = self.k + 1 if self.device_nms else self.k  # +1: flag row
        if packed.shape[1] != rows:
            return False
        if self.device_nms:
            return bool((packed[:, -1, 0] > 0).any())
        return bool((packed[:, :, 5:].max(axis=-1) > 0).all(axis=-1).any())

    def _grow_and_promote(self) -> "DetectionPipeline":
        """Build (or reuse) the Kx4 pipeline and promote future dispatches to
        it. Thread-safe: stream() grows from finish-worker threads."""
        with self._grow_lock:
            new_k = min(self._max_k, self.k * 4)
            print(f"note: candidate buffer K={self.k} saturated; re-running "
                  f"batch with K={new_k} (future batches use the grown buffer)",
                  file=sys.stderr)
            grown = self._grown(new_k)
            # promote: saturating workloads shouldn't pay a double forward
            # per batch
            self._promoted = grown
            return grown

    def _finish_batch(self, packed: np.ndarray, im_sizes=None):
        """Per-image host finish over an already-fetched packed batch."""
        netw, neth = self.spec.net.w, self.spec.net.h
        out = []
        for i in range(packed.shape[0]):
            w, h = im_sizes[i] if im_sizes is not None else (netw, neth)
            out.append(self._finish(packed[i], w, h))
        return out

    def serve_scan(self, frames, im_sizes=None):
        """Multi-frame serving loop: a device-resident ring of N frames runs
        SEQUENTIALLY at b=1 (one replay of the b=1 graph per frame, each
        writing row i of one [N, K(+1), 4+1+classes] buffer) and every
        frame's detections come from ONE D2H fetch. Each frame is exactly
        the b=1 program, so the results are bit-identical to frame-at-a-time
        calls. ``frames``: [N, H, W, C] f32/uint8 or planar YUV420
        [N, H*3/2, W], any source size. Returns list[Detections], saturation
        auto-grow included."""
        if self._pp is not None or self._mesh is not None:
            raise ValueError("serve_scan is the single-device serving loop; "
                             "compose pp/mesh with batch dispatch instead")
        if self._promoted is not None:
            return self._promoted.serve_scan(frames, im_sizes)
        ring = _as_input(frames)
        if im_sizes is None:
            im_sizes = _source_sizes(tuple(ring.shape), self.spec)
        with profiling.span("dispatch") as s:
            out, done = self._scan(ring)
        return self._land(out, done, im_sizes,
                          lambda grown: grown.serve_scan(frames, im_sizes),
                          s.request)

    def _scan(self, ring: torch.Tensor):
        """:meth:`serve_scan`'s device half: the ring's one H2D transfer and
        a replay of the b=1 graph a frame into one packed buffer; returns it
        and, on the graph path, the event after the last replay."""
        with torch.inference_mode(), self._run_lock:
            if not self._cuda_graph:
                ring = ring.to(self.device)
                return torch.cat([self.run(ring[i:i + 1])
                                  for i in range(ring.shape[0])]), None
            ring = self._h2d(ring)                     # one H2D transfer
            g = self._graph_for(ring[:1])
            out = torch.empty((ring.shape[0],) + g.static_out.shape[1:],
                              dtype=g.static_out.dtype, device=self.device)
            for i in range(ring.shape[0]):
                with profiling.span("dispatch.replay") as s:
                    self._replay(g, ring[i:i + 1], s, out[i:i + 1])
            return out, self._done()

    def __call__(self, images, im_sizes=None):
        """Full pipeline for a batch. ``im_sizes``: list of (w,h) original
        image sizes for coordinate correction (defaults to net dims, or the
        source dims of device-resized frames). Returns list[Detections]
        after exact per-class NMS.

        If the candidate buffer saturates (all K slots used — detections may
        have been dropped), the batch transparently re-runs with K x4, up to
        the net's total candidate count (4096 under device_nms)."""
        return self.collect(self.dispatch(images), im_sizes)

    def _grown(self, new_k: int) -> "DetectionPipeline":
        """A pipeline identical to this one but with a larger candidate
        buffer, sharing this one's converted params and parallel engine
        (cached, so repeated saturation does not capture again every
        batch)."""
        cached = self._grown_cache
        if cached is None or cached.k != new_k:
            cached = DetectionPipeline(
                self.spec, self.params, self._mode, thresh=self.thresh,
                nms=self.nms, k=new_k, int8_policy=self._int8_policy,
                compute_dtype=self._compute_dtype, letter=self.letter,
                xnor_impl=self._xnor_impl, device_nms=self.device_nms,
                turbo=self._turbo, int8_impl=self._int8_impl,
                device=self.device, cuda_graph=self._cuda_graph,
                int8_chain=self._int8_chain, mesh=self._mesh,
                pp_stages=self._pp_stages, pp_microbatch=self._pp_microbatch,
                pp_tp=self._pp_tp, _parallel=(self._pp, self._sharded))
            self._grown_cache = cached
        return cached

    def stream(self, batches, im_sizes_iter=None, depth: int = 2,
               workers: int = 1):
        """Pipelined streaming inference: keeps ``depth`` batches in flight
        on the device AND runs the host finish stage (D2H fetch + NMS) in
        ``workers`` threads, so device compute and host NMS overlap.

        ``batches``: iterable of [B,H,W,C] arrays. Yields lists of Detections
        in submission order. Saturation auto-grows the candidate buffer
        exactly like ``__call__``: the saturated batch re-runs at Kx4 and
        every LATER dispatch uses the grown pipeline; batches already in
        flight at the old K re-run individually if they also saturated."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        # at most ONE old-K in-flight batch re-runs at a time
        rerun_lock = threading.Lock()

        def finish_batch(ticket, sizes):
            pipe, packed_dev, done, xb, request = ticket

            def rerun(grown):
                with rerun_lock:
                    return grown(xb, sizes)
            return pipe._land(packed_dev, done, sizes, rerun, request)

        it = iter(batches)
        sizes_it = iter(im_sizes_iter) if im_sizes_iter is not None else None
        inflight: deque = deque()
        done = False
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            while True:
                while not done and len(inflight) < depth:
                    try:
                        xb = next(it)
                    except StopIteration:
                        done = True
                        break
                    sizes = (next(sizes_it) if sizes_it is not None else None)
                    # dispatch() follows the promotions to the grown K
                    inflight.append(pool.submit(finish_batch,
                                                self.dispatch(xb), sizes))
                if not inflight:
                    return
                yield inflight.popleft().result()

    def _finish(self, packed_i: np.ndarray, w: int, h: int):
        saturated = False
        if self.device_nms:
            # last row is the pre-NMS saturation flag (see post()); probs are
            # already suppressed on the device, so no host NMS
            saturated = packed_i[-1, 0] > 0
            packed_i = packed_i[:-1]
        boxes = packed_i[:, :4]
        obj = packed_i[:, 4]
        probs = packed_i[:, 5:]
        keep = probs.max(axis=-1) > 0
        if (self.k < self._total_candidates
                and (saturated or (keep.all()
                                   and packed_i.shape[0] == self.k))):
            print(f"warning: candidate buffer K={self.k} saturated; "
                  "some detections may be dropped (raise k)", file=sys.stderr)
        boxes, obj, probs = boxes[keep], obj[keep], probs[keep]
        boxes = post.correct_boxes(boxes.astype(np.float32), w, h,
                                   self.spec.net.w, self.spec.net.h,
                                   relative=True, letter=self.letter)
        dets = post.Detections(boxes.astype(np.float32),
                               obj.astype(np.float32),
                               probs.astype(np.float32))
        if self.nms and not self.device_nms:
            with profiling.span("finish.nms"):
                post.do_nms_sort(dets, self.classes, self.nms)
        return dets


def _converted(params: list) -> bool:
    """True for params already converted to tensors (``device_params``)."""
    return any(isinstance(v, torch.Tensor)
               for p in params if p is not None for v in p.values())
