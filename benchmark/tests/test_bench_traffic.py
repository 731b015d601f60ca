"""The seeded traffic: one seed gives the same pool, another seed another
pool of the same sizes; any whole number is a seed."""

import torch

from harness import spec, traffic
from reference.seeds import derive

MODEL = {"grd_size": [16, 32], "sat_size": [24, 24]}


def mix(name="train-b8"):
    return dict(spec.read_json(spec.BENCH / "traffic" / f"{name}.json"), pool=3)


def test_same_seed_same_pool():
    a, b = traffic.pool(mix(), MODEL, 2 ** 33 + 5, "cpu"), traffic.pool(mix(), MODEL, 2 ** 33 + 5, "cpu")
    for x, y in zip(a, b):
        for s, t in zip(x, y):
            assert torch.equal(s, t)


def test_other_seed_other_pool_same_sizes():
    a, b = traffic.pool(mix(), MODEL, 1, "cpu"), traffic.pool(mix(), MODEL, 2, "cpu")
    assert not torch.equal(a[0].grd, b[0].grd) and not torch.equal(a[0].angle_deg, b[0].angle_deg)
    for x, y in zip(a, b):
        assert [t.shape for t in x] == [t.shape for t in y]


def test_ranges():
    m = mix("serve-b8")
    for b in traffic.pool(m, MODEL, 7, "cpu"):
        assert b.grd.dtype == torch.uint8 and b.grd.shape == (m["batch"], 16, 32, 3)
        assert b.sat.shape == (m["batch"], 24, 24, 3)
        assert (b.row_offset.abs() <= m["row_offset"] * 24).all()
        assert (b.col_offset.abs() <= m["col_offset"] * 24).all()
        assert ((b.angle_deg >= 0) & (b.angle_deg < 360)).all()


def test_streams_are_separate_and_large_seeds_work():
    assert derive(3, "traffic") != derive(3, "weights") != derive(4, "weights")
    assert 0 <= derive(2 ** 40 + 1, "traffic") < 2 ** 63
