"""What a sharded forward of the port moves, counted from layer shapes alone:
the reference that ``tests/test_torch_commvol.py`` (mini cfgs on the CPU)
and ``chip_smoke.py`` phase 12 (yolov3-416 on the card) hold the recorder of
``yolo2_light_tpu_torch/parallel/commvol.py`` to. It imports nothing of JAX.
"""

import collections

import numpy as np

from yolo2_light_tpu_torch.cfg import (ConvSpec, MaxpoolSpec, ReorgSpec,
                                       RegionSpec, RouteSpec, ShortcutSpec,
                                       UpsampleSpec, YoloSpec)
from yolo2_light_tpu_torch.models.network import (_consumers,
                                                  _int8_chain_targets,
                                                  _int8_layer_set,
                                                  _trunk_targets)


def slab(spec, space, h, s):
    """Space position ``s``'s rows of an ``h``-row map: the coarsest grid's
    rows split as evenly as they go, scaled by h over it."""
    coarse = min([spec.net.h] + [l.out_h for l in spec.layers])
    bounds = np.concatenate(
        [[0], np.cumsum([len(a) for a in
                         np.array_split(np.arange(coarse), space)])])
    return int(bounds[s]) * h // coarse, int(bounds[s + 1]) * h // coarse


def in_shape(spec, l):
    if l.index == 0:
        return spec.net.h, spec.net.w, spec.net.c
    p = spec.layers[l.index - 1]
    return p.out_h, p.out_w, p.out_c


def int8_twins(spec):
    """The layers whose output carries an int8 tensor beside its float32
    one under ``-turbo_int8`` (int8 mode, the cpu policy, no fused runs):
    a conv or shortcut quantized at its trunk target where the int8 chain
    wants that target too (a shortcut always), and the maxpools, reorgs,
    unit upsamples and routes that pass such a tensor on to the chain's
    target. Both tensors cross a collective there."""
    int8_set = _int8_layer_set(spec, "cpu")
    trunk = _trunk_targets(spec, int8_set)
    chain = _int8_chain_targets(spec, int8_set)
    cur = None      # (holds a tensor, target) of the running output
    pairs = {}      # the same for the outputs a route reads
    twins = set()
    for l in spec.layers:
        i = l.index
        if isinstance(l, (ConvSpec, ShortcutSpec)):
            t = trunk.get(i)
            if t is not None and (isinstance(l, ShortcutSpec)
                                  or chain.get(i) == t):
                cur = (True, t)
            elif isinstance(l, ConvSpec) and chain.get(i) is not None:
                cur = (False, chain[i])
            else:
                cur = None
        elif isinstance(l, (MaxpoolSpec, ReorgSpec)) or (
                isinstance(l, UpsampleSpec) and l.scale == 1.0):
            if cur is None or chain.get(i) != cur[1]:
                cur = None
        elif isinstance(l, RouteSpec):
            srcs = [pairs.get(j) for j in l.layers]
            t = chain.get(i)
            cur = ((any(s[0] for s in srcs), t)
                   if t is not None and l.out_c and all(
                       s is not None and s[1] == t for s in srcs) else None)
        else:
            cur = None
        if cur is not None:
            pairs[i] = cur
            if cur[0]:
                twins.add(i)
    return twins


def expected_mesh(spec, axes, batch, twins=(), elem=4):
    """{(position, what): [count, bytes]} that a sharded forward of
    ``spec`` on ``axes`` (data, space, model sizes) at global batch
    ``batch`` moves, from layer shapes alone, float32 tensors at ``elem``
    bytes an element: the input's rows to every position but the first;
    under model, one gather of every sharded conv's output (M % model == 0,
    1x1 only under space), taken after the maxpools that alone read it;
    under space, the rows of each neighbour slab that a conv or maxpool
    window reads; the heads' pieces of every model-0 position onto the
    first. Where a gathered or haloed output is one of ``twins``
    (:func:`int8_twins`), its int8 tensor crosses beside it, an entry of
    its own at 1 byte an element."""
    D, S, M = (axes.get(a, 1) for a in ("data", "space", "model"))
    b = batch // D
    out = collections.defaultdict(lambda: [0, 0])

    def add(pos, what, elems, layer):
        for size in (elem, 1) if layer in twins else (elem,):
            if elems:
                out[pos, what][0] += 1
                out[pos, what][1] += elems * size

    consumers = _consumers(spec)
    for d in range(D):
        for s in range(S):
            for m in range(M):
                pos = (d, s, m)
                if pos != (0, 0, 0):
                    r0, r1 = slab(spec, S, spec.net.h, s)
                    add(pos, "scatter",
                        b * (r1 - r0) * spec.net.w * spec.net.c, -1)
                for l in spec.layers:
                    if (M > 1 and isinstance(l, ConvSpec) and l.n % M == 0
                            and (S == 1 or l.size == 1)):
                        g = l.index
                        while (consumers[g] == [g + 1] and isinstance(
                                spec.layers[g + 1], MaxpoolSpec)):
                            g += 1
                        o = spec.layers[g]
                        r0, r1 = slab(spec, S, o.out_h, s)
                        add(pos, "gather",
                            b * (r1 - r0) * o.out_w * o.out_c, g)
                    if S > 1 and isinstance(l, (ConvSpec, MaxpoolSpec)):
                        h, w, c = in_shape(spec, l)
                        origin = (l.pad if isinstance(l, ConvSpec)
                                  else l.pad // 2)
                        o0, o1 = slab(spec, S, l.out_h, s)
                        n0 = max(0, o0 * l.stride - origin)
                        n1 = min(h, (o1 - 1) * l.stride - origin + l.size)
                        for q in range(S):
                            if q == s:
                                continue
                            a, e = slab(spec, S, h, q)
                            rows = max(0, min(n1, e) - max(n0, a))
                            add(pos, "halo", b * rows * w * c, l.index - 1)
        for s in range(S):
            if (d, s) == (0, 0):
                continue
            for l in spec.layers:
                if isinstance(l, (YoloSpec, RegionSpec)):
                    r0, r1 = slab(spec, S, l.out_h, s)
                    add((0, 0, 0), "collect",
                        b * (r1 - r0) * l.out_w * l.out_c, -1)
    return dict(out)


def recorded(log):
    """{(position, what): [count, bytes]} of a recorder's log."""
    got = collections.defaultdict(lambda: [0, 0])
    for e in log.entries:
        got[e.position, e.what][0] += 1
        got[e.position, e.what][1] += e.nbytes
    return dict(got)
