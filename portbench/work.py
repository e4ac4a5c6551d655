"""The work of a network counted from its layer shapes, and the card's peaks.

Nothing here reads the program: the convs and their shapes come from the
reference's cfg parse, the arithmetic of each conv from the
configuration's mode, and the least time of each conv from its operations
and bytes at the published peaks of one NVIDIA H100 SXM (data sheet, dense
rates, 700 W): the larger of bytes over the HBM bandwidth and operations
over the peak of its arithmetic. Each input is read once and each output
written once.
"""

from __future__ import annotations

from dataclasses import dataclass

from .reference import net as ref_net

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


def conv_arith(net, mode: str) -> dict:
    """conv index -> the arithmetic it is computed in under ``mode``
    (``int8``: yolo2_light's -quantized, the first and the linear convs in
    float32; ``bf16``: every conv; ``f32``: every conv)."""
    if mode == "int8":
        ints = ref_net.integer_layers(net)
        return {l.index: "int8" if l.index in ints else "f32"
                for l in net.convs}
    if mode not in ("bf16", "f32"):
        raise ValueError(f"unknown mode {mode!r}")
    return {l.index: mode for l in net.convs}


def conv_work(net, mode: str) -> list:
    out = []
    for l, arith in zip(net.convs, conv_arith(net, mode).values()):
        k = l.size * l.size * l.c
        p = l.out_h * l.out_w
        wb = WEIGHT_BYTES[arith] * l.n * k + 4 * l.n
        out.append(ConvWork(l.index, arith, p * l.n * k,
                            4 * l.h * l.w * l.c + wb + 4 * p * l.n, wb))
    return out


def least_s(work: list, arith: str, images: int, batch: int) -> float:
    """The least time of the convs computed in ``arith`` over ``images``
    images run ``batch`` to a launch."""
    launches = images / batch
    return sum(c.least_s(batch) * launches for c in work if c.arith == arith)


def peak_s_per_image(work: list) -> float:
    """Every conv's operations at the peak of its arithmetic, one image."""
    return sum(c.peak_s(1) for c in work)
