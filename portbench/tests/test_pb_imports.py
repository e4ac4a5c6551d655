"""What the harness loads: never JAX, jaxlib, flax or the JAX package
(names compared whole before the first dot, so the port's own name does
not match), and a reference package (each that a configuration names, and
the tests' own) not even the port; and no fall-back to the CPU where
there is no card."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.model import DEFAULT_REFERENCE
from portbench.tests.conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "yolo2_light_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    top = _loaded(
        "import sys; sys.argv = ['run.py']\n"
        "import runpy; runpy.run_path('portbench/run.py', run_name='x')\n"
        "from portbench import bench, model, readings\n"
        "import yolo2_light_tpu_torch.pipeline, yolo2_light_tpu_torch.quant\n"
        "import yolo2_light_tpu_torch.weights, yolo2_light_tpu_torch.xnor\n"
        "import yolo2_light_tpu_torch.cfg")
    assert "yolo2_light_tpu_torch" in top
    assert not top & BANNED


def _packages() -> list:
    """The reference package of every configuration in BENCHMARK.json, and
    the tests' own, by their names under ``portbench``."""
    names = {"tests.ref_relu"}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    for c in configs:
        with open(os.path.join(ROOT, c["file"])) as f:
            names.add(json.load(f).get("reference", DEFAULT_REFERENCE))
    return sorted(names)


@pytest.mark.parametrize("package", _packages())
def test_the_reference_loads_neither_jax_nor_the_port(package):
    ref = os.path.join(ROOT, "portbench", *package.split("."))
    files = [os.path.relpath(os.path.join(d, n), ROOT)
             for d, _, names in os.walk(ref) for n in names
             if n.endswith(".py")]
    mods = [f[:-3].replace(os.sep, ".").removesuffix(".__init__")
            for f in files]
    top = _loaded("import " + ", ".join(sorted(mods)))
    assert not top & (BANNED | {"yolo2_light_tpu_torch"})
    for name in files:
        tree = ast.parse(open(os.path.join(ROOT, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            for m in mods:
                assert m.split(".")[0] not in BANNED | {
                    "yolo2_light_tpu_torch"}, (name, m)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import bench
    monkeypatch.setitem(sys.modules, "yolo2_light_tpu_torch_x", sys)
    assert bench.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & BANNED)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in bench.forbidden_modules()


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "yolov3-416-int8.cam1", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "is_available() is false" in out.stderr
