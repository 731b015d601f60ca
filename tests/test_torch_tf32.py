"""TF32 rounding and the 3xTF32 split of ops/tf32.py, the plain version of
the tensor-core primitive in csrc/lmu.cu (mma_3xtf32, which the fused stage
backward's weight gradients run on): round to nearest with ties away from
zero as cvt.rna.tf32.f32, hi + lo rebuilding float32, a 3xTF32 product
float32-accurate where one TF32 product is not, and the checks' dyadic
inputs (chip_smoke.py::lmu_inputs) splitting exactly. CPU only; the kernel
is held against float64 on the card by chip_smoke.py."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.ops import lmu_cuda
from ccvpe_tpu_torch.ops.tf32 import matmul_3xtf32_plain, round_tf32, split_tf32

ROOT = Path(__file__).resolve().parents[1]
LOW13 = (1 << 13) - 1
# a 3xTF32 product against float64, relative to the output's max (the
# probe's bound in chip_smoke.py)
PRODUCT_RTOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _low_bits(t):
    return t.contiguous().view(torch.int32) & LOW13


def _rna_reference(a: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, ties away from zero, in float64 (frexp
    gives a mantissa in [0.5, 1), so 2^11 * m holds the 11 kept bits)."""
    m, e = np.frexp(a.astype(np.float64))
    kept = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(kept / 2.0 ** 11, e).astype(np.float32)


def _inputs(kind: str, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        a = rng.standard_normal(4096)
    elif kind == "wide":        # exponents from 2^-60 to 2^60, both signs
        a = rng.choice([-1.0, 1.0], 4096) * 2.0 ** rng.uniform(-60, 60, 4096)
    else:                       # exact ties: 10 kept mantissa bits, then a 1
        kept = rng.integers(0, 1 << 10, 4096)
        a = rng.choice([-1.0, 1.0], 4096) * (1 + kept / 2.0 ** 10 + 2.0 ** -11) * 2.0 ** rng.integers(-8, 8, 4096)
    return torch.from_numpy(a.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
def test_round_tf32_matches_rna_reference(kind):
    a = _inputs(kind, 0)
    got = round_tf32(a)
    np.testing.assert_array_equal(got.numpy(), _rna_reference(a.numpy()))
    assert int(_low_bits(got).abs().max()) == 0


@pytest.mark.parametrize("value, rounded", [
    (1 + 2 ** -11, 1 + 2 ** -10),           # tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),        # tie with an odd kept bit: still away
    (1 + 2 ** -12, 1.0),                     # below half a unit: down
    (float("inf"), float("inf")),
    (0.0, 0.0),
])
def test_round_tf32_values(value, rounded):
    assert float(round_tf32(torch.tensor([value], dtype=torch.float32))[0]) == rounded


def test_round_tf32_passes_nan():
    assert torch.isnan(round_tf32(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_clears_low_bits_and_rebuilds(kind, seed):
    a = _inputs(kind, seed)
    hi, lo = split_tf32(a)
    assert int(_low_bits(hi).abs().max()) == 0
    assert int(_low_bits(lo).abs().max()) == 0
    rebuilt = hi.double() + lo.double()
    assert bool(((rebuilt - a.double()).abs() <= 2.0 ** -21 * a.double().abs()).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_product_is_float32_accurate_and_1xtf32_is_not(seed):
    """Dot products of length 9 * 56 (conv_a's taps x channels at VIGOR loc
    stage 5) against float64: 3xTF32 within PRODUCT_RTOL of the max, one
    TF32 product outside it, so the bound tells the two apart."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((8, 9 * 56)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((9 * 56, 8)).astype(np.float32))
    want = a.double() @ b.double()
    scale = float(want.abs().max())
    err3 = float((matmul_3xtf32_plain(a, b).double() - want).abs().max()) / scale
    err1 = float(((round_tf32(a) @ round_tf32(b)).double() - want).abs().max()) / scale
    assert err3 <= PRODUCT_RTOL
    assert err1 > PRODUCT_RTOL


def _lmu_shapes():
    cs = _chip_smoke()
    return cs.lmu_call_shapes(cfg_lib.vigor(), 1) + cs.lmu_call_shapes(
        cfg_lib.kitti(), 1, "kitti ") + [
        ("ragged, no skip, Cout 1", 1, 13, 21, 9, 0, 8, 12, 1),
        ("ragged channels", 1, 7, 11, 5, 3, 7, 9, 3),
    ]


@pytest.mark.parametrize("shape", _lmu_shapes(), ids=lambda s: s[0])
def test_dyadic_check_inputs_split_exactly(shape):
    """x, skip and the weights of chip_smoke.py's B3 check are small dyadic
    numbers: each is one TF32 value (lo == 0), so TF32 splitting cannot move
    B3's recompute of the ReLU mask. dy, drawn normal, is not."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x, skip, ws = cs.lmu_inputs(shape, gen, dyadic=True, device="cpu")
    for t in [x] + ([skip] if skip is not None else []) + list(ws):
        assert not bool(split_tf32(t)[1].any())
    dy = torch.randn(shape[1], 2 * shape[2], 2 * shape[3], shape[8], generator=gen)
    assert bool(split_tf32(dy)[1].any())


@pytest.mark.parametrize("m, n, k", [(81, 40, 64), (56, 1, 16), (5, 3, 4)])
def test_mma_probe_takes_the_plain_version_on_cpu(m, n, k):
    rng = np.random.default_rng(m * n * k)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    before = lmu_cuda.mma_probe.launches
    torch.testing.assert_close(lmu_cuda.mma_probe(a, b), matmul_3xtf32_plain(a, b), rtol=0, atol=0)
    assert lmu_cuda.mma_probe.launches == before


def test_mma_probe_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        lmu_cuda.mma_probe(torch.zeros(4, 3), torch.zeros(4, 2))
