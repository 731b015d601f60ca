"""The control of every cell comes out not correct, on the card, at the
cell's own size, on three seeds: the plain reference put in the program's
place in TF32, the nearest precision below the configurations' float32
(benchmark/calibrate.py reads the same numbers for PERF.md).

    python -m pytest benchmark/tests/test_bench_control.py -q -m card"""

import pytest
import torch

from harness import check, drivers, spec

SEEDS = (3_300_000_011, 3_300_000_029, 3_300_000_047)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    cell = spec.cell(name)
    for seed in SEEDS:
        d = drivers.DRIVERS[cell.kind](cell, seed, card)
        d.make_pool()
        numbers = d.check({"tf32": True})["numbers"]
        assert not check.verdict(numbers, cell.limits), (seed, numbers)
        del d
        torch.cuda.empty_cache()
