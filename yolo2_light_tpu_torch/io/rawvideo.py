# Mirrors yolo2_light_tpu/io/rawvideo.py: a copy, so that the port imports
# nothing of the JAX package.
"""Raw BGR24 video container (magic ``CVSTUBV1``) — deterministic frame ingest.

Compressed containers make byte-parity testing impossible (codecs differ per
host build), and benchmark ingest should not pay a decode. This trivial
container carries frames exactly as a capture would hand them to the detector:

    bytes 0-7   magic ``CVSTUBV1``
    int32 x 4   width, height, n_frames, fps        (little-endian)
    then n_frames x (height*width*3) bytes of BGR24, row-major

The same format feeds the compiled reference demo oracle through the test
OpenCV stub (tests/data/cvstub/), so both implementations consume identical
bytes — the demo analog of the PNG rule used for image parity (JPEG decoders
differ; tests/conftest.py). ``RawVideoCapture`` mirrors the small slice of the
``cv2.VideoCapture`` API the demo uses, so ``apps/demo.py`` can swap it in by
sniffing the file magic.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"CVSTUBV1"
_HDR = struct.Struct("<4i")


def is_rawvideo(filename) -> bool:
    """True if ``filename`` is a CVSTUBV1 raw-BGR stream (by magic, not name)."""
    if not isinstance(filename, str):
        return False
    try:
        with open(filename, "rb") as f:
            return f.read(8) == MAGIC
    except OSError:
        return False


class RawVideoCapture:
    """cv2.VideoCapture-shaped reader for CVSTUBV1 files (read/get/isOpened/
    release — the subset the demo uses)."""

    def __init__(self, filename: str):
        self._f = None
        self.w = self.h = self.n = self.fps = 0
        self._pos = 0
        try:
            f = open(filename, "rb")
        except OSError:
            return
        if f.read(8) != MAGIC:
            f.close()
            return
        hdr = f.read(_HDR.size)
        if len(hdr) != _HDR.size:
            f.close()
            return
        self.w, self.h, self.n, self.fps = _HDR.unpack(hdr)
        self._f = f

    def isOpened(self) -> bool:
        return self._f is not None

    def read(self):
        """(ok, BGR uint8 HxWx3) like cv2; (False, None) at stream end."""
        if self._f is None or self._pos >= self.n:
            return False, None
        raw = self._f.read(self.w * self.h * 3)
        if len(raw) != self.w * self.h * 3:
            return False, None
        self._pos += 1
        return True, np.frombuffer(raw, np.uint8).reshape(self.h, self.w, 3)

    def get(self, prop) -> float:
        # CAP_PROP_FPS=5, CAP_PROP_FRAME_WIDTH=3, CAP_PROP_FRAME_HEIGHT=4
        # (OpenCV's stable C-era property ids, highgui_c.h)
        return float({3: self.w, 4: self.h, 5: self.fps}.get(int(prop), 0))

    def release(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def write_rawvideo(filename: str, frames, fps: int = 25) -> None:
    """Write BGR uint8 HxWx3 ``frames`` as a CVSTUBV1 file."""
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    with open(filename, "wb") as f:
        f.write(MAGIC)
        f.write(_HDR.pack(w, h, len(frames), fps))
        for fr in frames:
            if fr.shape != (h, w, 3):
                raise ValueError(f"frame shape {fr.shape} != {(h, w, 3)}")
            f.write(fr.tobytes())
