"""Fixtures of the benchmark's CPU tests: a small net (the repository's
mini-yolo3 test cfg, 64x64, 3 classes) under configuration and traffic
files shaped like the benchmark's, so a whole run fits a test."""

import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
MINI_CFG = os.path.join(ROOT, "tests", "data", "mini-yolo3.cfg")
MINI_SHAPE = {"input": [64, 64, 3], "layers": 16, "convs": 8,
              "classes": [3], "params": 31840}
PROGRAM = {"int8": {"mode": "int8", "int8_policy": "cpu", "int8_impl": "xla",
                    "compute_dtype": "float32"},
           "f32": {"mode": "fp32", "compute_dtype": "float32"}}
CONTROL = {"int8": "int4", "f32": "bf16"}


def parsed(path: str = MINI_CFG):
    """The default reference's net of the cfg at ``path``, carrying that
    package (``net.ref``) as ``model.load_config`` hands a net on."""
    from portbench import reference
    net = reference.parse(path)
    net.ref = reference
    return net


def mini_files(tmp_path, arith: str, traffic: str, limits=None,
               cfg_path: str = MINI_CFG, reference=None) -> dict:
    """Configuration, traffic and limits files of the small net (or of
    another cfg of its shape) for a cell of ``arith`` under the
    benchmark's ``traffic``, cut to a test's size; the configuration names
    ``reference`` where given."""
    cfg = {"name": f"mini-{arith}", "cfg": cfg_path, "shape": MINI_SHAPE,
           "reduced": [], "arith": arith,
           "control": CONTROL[arith],
           "program": PROGRAM[arith], "kernels": []}
    if reference is not None:
        cfg["reference"] = reference
    with open(os.path.join(ROOT, "portbench", "traffic",
                           f"{traffic}.json")) as f:
        tr = json.load(f)
    tr.update(pool=8, frame=[48, 64, 3], batch=min(tr["batch"], 4),
              sample=6, trace_warm=1, trace_requests=2, candidates=20)
    files = {}
    for kind, body in (("config", cfg), ("traffic", tr),
                       ("limits", limits or {"unlike_pct": 2.0})):
        p = tmp_path / f"{kind}-{arith}-{traffic}.json"
        p.write_text(json.dumps(body))
        files[kind] = str(p)
    return files


@pytest.fixture
def mini(tmp_path):
    return lambda arith, traffic, limits=None, **kw: mini_files(
        tmp_path, arith, traffic, limits, **kw)
