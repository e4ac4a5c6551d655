# Mirrors yolo2_light_tpu/utils/crand.py: a copy, so that the port imports
# nothing of the JAX package.
"""glibc ``rand()`` emulation for darknet construction-time weight init.

The reference initialises every conv layer's weights at construction with
``scale * rand_uniform(-1, 1)`` (make_convolutional_layer,
src/additionally.c:2751-2752) BEFORE any ``srand`` call in the apps, i.e. from
glibc's default seed 1 — except that ``make_yolo_layer``/``make_region_layer``
call ``srand(0)`` (src/additionally.c:2543,2593), resetting the stream for any
conv constructed after a head. Layers whose cfg sets ``dontload=1`` keep these
init weights (the loader skips them, src/additionally.c:3522), so bit-exact
oracle parity for such layers requires reproducing the glibc TYPE_3 generator
and the reference's exact float32 expression.

The TYPE_3 additive-feedback algorithm implemented here is public knowledge
(glibc stdlib/random_r.c): state of 34 words, ``r[i] = 16807*r[i-1] mod 2^31-1``
for i in 1..30, ``r[i] = r[i-31]`` for 31..33, then
``r[i] = (r[i-3] + r[i-31]) mod 2^32`` with the first 310 outputs discarded;
each output is ``r[i] >> 1``.
"""

from __future__ import annotations

import numpy as np


class GlibcRand:
    """Bit-exact glibc ``rand()`` (TYPE_3, the default for ``srand``)."""

    def __init__(self, seed: int = 1):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            # Schrage-free: python ints make the 16807 LCG step exact.
            r[i] = (16807 * r[i - 1]) % 2147483647
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        self._r = r          # ring buffer, index mod 344 after warmup
        self._i = 344

    def rand(self) -> int:
        r = self._r
        i = self._i
        val = (r[(i - 3) % 344] + r[(i - 31) % 344]) & 0xFFFFFFFF
        r[i % 344] = val
        self._i = i + 1
        return val >> 1

    def rand_n(self, n: int) -> np.ndarray:
        return np.array([self.rand() for _ in range(n)], dtype=np.int64)


def rand_uniform_f32(vals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The reference's ``rand_uniform`` (src/additionally.c:1770-1778) in exact
    float32 arithmetic: ``(float)rand() / RAND_MAX * (max-min) + min`` where
    RAND_MAX converts to float32 as 2^31."""
    f = vals.astype(np.float32)
    denom = np.float32(2147483647)  # rounds to 2^31 like the C conversion
    span = np.float32(np.float32(hi) - np.float32(lo))
    return (f / denom * span + np.float32(lo)).astype(np.float32)


def darknet_conv_init(spec) -> dict:
    """Construction-time random weights for every conv layer of ``spec``,
    replaying the reference's rand() consumption order: each conv draws
    ``c*n*size*size`` values; each yolo/region constructor resets to srand(0)
    (src/additionally.c:2543,2593,2751-2752).

    Returns ``{layer_index: weights HWIO float32}``.
    """
    from ..cfg import ConvSpec, RegionSpec, YoloSpec

    stream = GlibcRand(1)  # process default seed; apps srand() only after parse
    out = {}
    for i, l in enumerate(spec.layers):
        if isinstance(l, (YoloSpec, RegionSpec)):
            stream = GlibcRand(0)
        elif isinstance(l, ConvSpec):
            count = l.c * l.n * l.size * l.size
            scale = np.float32(np.sqrt(2.0 / (l.size * l.size * l.c)))
            u = rand_uniform_f32(stream.rand_n(count), -1.0, 1.0)
            w = (scale * u).astype(np.float32)
            # darknet OIHW -> our HWIO
            out[i] = np.transpose(w.reshape(l.n, l.c, l.size, l.size),
                                  (2, 3, 1, 0)).copy()
    return out
