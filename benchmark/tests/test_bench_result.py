"""A whole run on the CPU at tiny widths through the harness: the last
line's schema; a dummy mix and a dummy metric, added as files and entries
alone, picked up by name; no result without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from _cells import tiny_cell
from harness import main, spec


@pytest.mark.parametrize("name,trace", [("vigor-train-b8", False), ("kitti-serve-b8", True)])
def test_result_line(name, trace):
    cell = tiny_cell(name)
    r = main.run(cell, 2 ** 32 + 3, 0.5, trace, "cpu")
    line = main.result_line(r, {"platform": "gpu", "kind": "test", "count": 1})
    keys = list(line)
    assert keys[:4] == ["correct", "attempted", "failed", "metrics"] and keys[-1] == "compared"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["compared"]) == set(cell.limits)
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(line["metrics"])
    if trace:       # no kernel of the card ran: the rooflines read nothing
        assert got == {n for n in want if "roofline" not in n}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        assert got == want
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] == v["value"]
    json.dumps(line)


DUMMY_METRIC = '''"""Requests a second in the traced window."""

KIND = "serve"


def read(w):
    return w.steps / w.window_s
'''


def test_a_new_mix_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix, limits and a metric
    as new files and BENCHMARK.json entries, and run the new cell."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    tiny = tiny_cell("vigor-serve-b8")
    (root / "benchmark/configs/dummy.json").write_text(json.dumps(dict(tiny.config)))
    (root / "benchmark/traffic/dummy-mix.json").write_text(json.dumps(
        dict(tiny.traffic, pool=2)))
    (root / "benchmark/limits/dummy-cell.json").write_text(json.dumps(tiny.limits))
    (root / "benchmark/metrics/requests_per_s.serve.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "dummy", "source": "test", "file":
                             "benchmark/configs/dummy.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-mix",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "serve-b8" in " ".join(m.get("workloads", [])):
            m["workloads"].append("dummy-cell")
    bench["per_layer"].append({"name": "requests_per_s.serve", "unit": "1/s", "better": "higher",
                               "source": "device_trace", "layer": "engine",
                               "moves": "serve_pairs_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path[:0] = [sys.argv[1] + '/benchmark', sys.argv[2]]\n"
            "from harness import main, spec\n"
            "r = main.run(spec.cell('dummy-cell'), 5, 0.5, True, 'cpu')\n"
            "print(json.dumps([sorted(r['metrics']), r['correct']]))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(root), str(spec.ROOT)],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    names, correct = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "requests_per_s.serve" in names and correct is True


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload",
                           "vigor-serve-b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr
