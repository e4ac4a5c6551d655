"""BENCHMARK.json against the rules of its format, and the files it names."""

import json
import os
import re

import pytest

from portbench import bench, model, verify
from portbench.tests.conftest import MINI_CFG, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
M = bench.load_manifest()
CELLS = {w["name"] for w in M["workloads"]}


def test_top_level_keys_command_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_lines_use_only_the_allowed_characters():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/")
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len(names) == len(set(names))


def test_every_layer_metric_is_reported_where_the_metric_it_moves_is():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.add(m["layer"])
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in CELLS:
        reported = [m for m in M["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert bench.metrics_of(M, cell, True)


def test_every_named_file_is_there():
    for c in M["configs"]:
        config, net = model.load_config(os.path.join(ROOT, c["file"]))
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        ref = net.ref
        assert ref.__name__ == "portbench." + config.get(
            "reference", model.DEFAULT_REFERENCE)
        for name in model.INTERFACE:
            assert callable(getattr(ref, name)), (ref.__name__, name)
    for w in M["workloads"]:
        files = bench.cell_files(M, w["name"])
        for path in files.values():
            assert os.path.exists(path), path
        with open(files["limits"]) as f:
            limits = json.load(f)
        assert any(k in limits for k in verify.NUMBERS)
    for m in M["end_to_end"] + M["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_a_small_net_under_a_full_models_name_is_refused(tmp_path):
    path = os.path.join(ROOT, "portbench", "configs", "yolov3-416-int8.json")
    with open(path) as f:
        c = json.load(f)
    c["cfg"] = MINI_CFG
    bad = tmp_path / "yolov3-416-int8.json"
    bad.write_text(json.dumps(c))
    with pytest.raises(model.ConfigError, match="is not the network"):
        model.load_config(str(bad))
