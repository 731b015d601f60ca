"""What a run measures, found by name: the cell in BENCHMARK.json, its
configuration (benchmark/configs/<config>.json), its traffic mix
(benchmark/traffic/<traffic>.json), the limits of its comparison with the
reference (benchmark/limits/<cell>.json), its metrics, and each per-layer
metric's reader (benchmark/metrics/<name>.py). A later cell, mix, metric or
configuration is a new file and a new entry; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]      # benchmark/
ROOT = BENCH.parent                              # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict            # the configuration file: source, model, train, assumed, reduced
    traffic: dict           # the traffic mix's parameters
    limits: dict            # number -> limit of the comparison with the reference
    end_to_end: List[dict]  # the entries of BENCHMARK.json this cell reports
    per_layer: List[dict]

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    bench = benchmark() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        config=read_json(ROOT / conf["file"]),
        traffic=read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def load_file(path: Path) -> ModuleType:
    """Import a file by its path (metric files are named after their
    metrics, which hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> ModuleType:
    return load_file(BENCH / "metrics" / f"{name}.py")


def work_counter(function: str) -> ModuleType:
    return importlib.import_module(f"work.{function}")
