"""ops/_build: a kernel's library is keyed by its source and by the csrc/
headers, so a changed header never reuses a stale build. Runs without nvcc:
only the key is computed."""

import os

from yolo2_light_tpu_torch.ops import _build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    _write(tmp_path / "k.cu", '#include "h.cuh"\nint k;\n')
    _write(tmp_path / "h.cuh", "#pragma once\nint h;\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    _write(tmp_path / "h.cuh", "#pragma once\nint h2;\n")
    assert _build.library_path("k") != first
    assert os.path.dirname(first) == _build.BUILD_DIR


def test_each_kernel_has_its_own_library():
    names = ("int8_conv", "fused_res", "xnor_gemm", "xnor_gemm_mxu",
             "nms_walk", "nms_order", "bf16_conv")
    paths = {name: _build.library_path(name) for name in names}
    for name, path in paths.items():
        assert os.path.basename(path).startswith(f"{name}-")
    assert len(set(paths.values())) == len(names)
