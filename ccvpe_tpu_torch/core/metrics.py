"""Structured metric logging, the port of ccvpe_tpu/core/metrics.py: CSV and
JSONL rows always, TensorBoard when torch.utils.tensorboard imports.

Each row is `step`, `time`, then the scalars; the CSV header is written once,
from the first row's keys (a later row's extra keys go to the JSONL only).
Replaces the reference's print-every-200-steps and np.savetxt appends
(reference train_VIGOR.py:155-157, :221-241)."""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, directory: str, run_name: str = "run"):
        os.makedirs(directory, exist_ok=True)
        self._csv_path = os.path.join(directory, f"{run_name}.csv")
        self._jsonl_path = os.path.join(directory, f"{run_name}.jsonl")
        self._fieldnames = None
        try:   # optional: TensorBoard needs the tensorboard package
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(directory, "tb"))
        except ImportError:
            self._tb = None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if f.tell() == 0:
                w.writeheader()
            w.writerow(row)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
