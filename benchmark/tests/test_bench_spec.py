"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name: configurations, mixes, limits, metric readers, work counts."""

import json
import re

import pytest

from harness import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"] and B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in B[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in B[key]}) == len(B[key])
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}


@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]])
def test_every_cell_loads_by_name(name):
    c = spec.cell(name)
    assert c.kind in ("train", "serve")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:            # each reports the metric it moves
        assert m["moves"] in e2e
        assert spec.metric_reader(m["name"]).KIND == c.kind
    assert set(c.limits) == ({"loss1_rel", "grad_gap", "change_median"} if c.kind == "train"
                             else {"prob_rel", "angle_deg"})


@pytest.mark.parametrize("conf", B["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    doc = json.loads((spec.ROOT / conf["file"]).read_text())
    assert {"source", "model", "train", "assumed", "reduced"} <= set(doc)
    assert doc["reduced"] == conf["reduced"]
    assert doc["model"]["name"] == conf["name"] and doc["model"]["lmu_fused_min_res"] == 256
    from harness.drivers import model_config
    model_config(doc["model"])        # the program takes it as it is
