"""The work of a network counted from its layer shapes, and the card's peaks.

Nothing here reads the program: the convs and their shapes come from the
configuration's reference (``net.ref``), its cfg parse and the arithmetic
it gives each conv under the configuration's mode (``conv_arith``), and
the least time of each conv from its operations and bytes at the
published peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W):
the larger of bytes over the HBM bandwidth and operations over the peak of
its arithmetic. Each input is read once and each output written once. A
reference package that exports ``conv_work`` counts its convs' operations
and bytes itself; the peaks stay this module's, and an arithmetic the data
sheet gives no peak for has no least time (its convs' rooflines and the
step's share of the peak read nothing).
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BYTES = 3.35e12                 # HBM3, bytes a second
PEAK_OPS = {                         # operations a second, by arithmetic
    "int8": 1979e12,                 # int8 tensor cores
    "bf16": 989e12,                  # bf16 tensor cores
    "f32": 67e12,                    # float32 outside the tensor cores
}
# bytes of an element as each arithmetic's conv reads and writes it: the
# float32 input map (the int8 and bf16 convs quantize or round it as they
# read it), the weights in the arithmetic's own type, float32 bias and
# output
WEIGHT_BYTES = {"int8": 1, "bf16": 2, "f32": 4}


@dataclass
class ConvWork:
    index: int
    arith: str
    macs: int          # multiply-adds of one image
    bytes: int         # bytes of one image (weights counted once a launch)
    weight_bytes: int

    def ops(self) -> float:
        return 2.0 * self.macs

    def least_s(self, images: int) -> float:
        """The least time of this conv over ``images`` images run as one
        launch: the larger of its bytes and its operations at peak."""
        b = (self.bytes - self.weight_bytes) * images + self.weight_bytes
        return max(b / PEAK_BYTES, self.ops() * images / PEAK_OPS[self.arith])

    def peak_s(self, images: int) -> float:
        """Its operations at the peak of its arithmetic."""
        return self.ops() * images / PEAK_OPS[self.arith]


def conv_work(net, mode: str) -> list:
    """The :class:`ConvWork` of every conv of ``net`` under ``mode``."""
    ref = net.ref
    if hasattr(ref, "conv_work"):
        return ref.conv_work(net, mode)
    out = []
    for l, arith in zip(net.convs, ref.conv_arith(net, mode).values()):
        k = l.size * l.size * l.c
        p = l.out_h * l.out_w
        wb = WEIGHT_BYTES[arith] * l.n * k + 4 * l.n
        out.append(ConvWork(l.index, arith, p * l.n * k,
                            4 * l.h * l.w * l.c + wb + 4 * p * l.n, wb))
    return out


def least_s(work: list, arith: str, images: int,
            batch: int) -> float | None:
    """The least time of the convs computed in ``arith`` over ``images``
    images run ``batch`` to a launch; None where ``arith`` has no peak."""
    if arith not in PEAK_OPS:
        return None
    launches = images / batch
    return sum(c.least_s(batch) * launches for c in work if c.arith == arith)


def peak_s_per_image(work: list) -> float | None:
    """Every conv's operations at the peak of its arithmetic, one image;
    None where a conv's arithmetic has no peak."""
    if any(c.arith not in PEAK_OPS for c in work):
        return None
    return sum(c.peak_s(1) for c in work)
