"""The port never imports JAX or the JAX package: it carries its own copies
of the host modules it needs. Its chip check refuses to run without a CUDA
device."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import yolo2_light_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(yolo2_light_tpu_torch.__file__)


def _port_modules():
    mods = ["yolo2_light_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], "yolo2_light_tpu_torch."):
        if not info.name.endswith("__main__"):
            mods.append(info.name)
    return mods


def test_port_modules_are_found():
    mods = _port_modules()
    for m in ("yolo2_light_tpu_torch.ops.int8_conv",
              "yolo2_light_tpu_torch.ops.fused_res",
              "yolo2_light_tpu_torch.ops.xnor_gemm",
              "yolo2_light_tpu_torch.xnor",
              "yolo2_light_tpu_torch.ops._build",
              "yolo2_light_tpu_torch.models.layers",
              "yolo2_light_tpu_torch.models.network",
              "yolo2_light_tpu_torch.params",
              "yolo2_light_tpu_torch.apps.detect",
              "yolo2_light_tpu_torch.apps.cli",
              "yolo2_light_tpu_torch.apps.map",
              "yolo2_light_tpu_torch.apps.calibrate",
              "yolo2_light_tpu_torch.quant",
              "yolo2_light_tpu_torch.eval.map",
              "yolo2_light_tpu_torch.ops.nms_walk",
              "yolo2_light_tpu_torch.ops.nms_order",
              "yolo2_light_tpu_torch.ops.resize",
              "yolo2_light_tpu_torch.pipeline",
              "yolo2_light_tpu_torch.post.device_decode",
              "yolo2_light_tpu_torch.post.device_nms",
              "yolo2_light_tpu_torch.ops.bf16_conv",
              "yolo2_light_tpu_torch.apps.demo",
              "yolo2_light_tpu_torch.io.rawvideo",
              "yolo2_light_tpu_torch.utils.profiling",
              "yolo2_light_tpu_torch.post.boxes_legacy",
              "yolo2_light_tpu_torch.utils.voc_label",
              "yolo2_light_tpu_torch.utils.distribution"):
        assert m in mods


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['yolo2_light_tpu'] = None\n"
            "import importlib\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "loaded = sorted(k for k, v in sys.modules.items()\n"
            "                if v is not None and (k == 'jax'\n"
            "                or k.startswith(('jax.', 'jaxlib'))\n"
            "                or k == 'yolo2_light_tpu'\n"
            "                or k.startswith('yolo2_light_tpu.')))\n"
            "assert not loaded, loaded\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"


# ``import yolo2_light_tpu``, ``from yolo2_light_tpu.x import`` and the like;
# not ``yolo2_light_tpu_torch``
_JAX_PACKAGE_IMPORT = re.compile(r"^(import|from)\s+yolo2_light_tpu(\.|\s|$)")


def test_no_jax_import_statements():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not s.startswith(("import jax", "from jax")), (path, s)
                assert not _JAX_PACKAGE_IMPORT.match(s), (path, s)


def test_the_package_import_pattern():
    for s in ("import yolo2_light_tpu", "from yolo2_light_tpu.cfg import X",
              "from yolo2_light_tpu import quant",
              "import yolo2_light_tpu.weights as w"):
        assert _JAX_PACKAGE_IMPORT.match(s), s
    for s in ("import yolo2_light_tpu_torch",
              "from yolo2_light_tpu_torch.cfg import X", "from . import cfg"):
        assert not _JAX_PACKAGE_IMPORT.match(s), s


def test_chip_smoke_imports_nothing_of_the_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        for line in f:
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "yolo2_light_tpu"
                            or mod.startswith("yolo2_light_tpu.")), s


def _chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=300, env=dict(os.environ, PYTHONPATH=""))


def test_chip_smoke_fails_without_cuda():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("checks the behaviour of a host without a CUDA device")
    r = _chip_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _chip_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
