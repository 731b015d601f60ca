"""The launch plan of the correlation kernel (ops/corr_cuda.py::corr_plan)
and the constants it mirrors from csrc/corr.cu. Pure Python: nothing is
compiled or launched here."""

import re

import pytest

from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.csrc import build
from ccvpe_tpu_torch.ops import corr_cuda
from ccvpe_tpu_torch.ops.corr_cuda import corr_plan, smem_bytes


def vigor_scales(batch=8):
    """(B, N, D, K) of the six correlations of one VIGOR forward."""
    cfg = cfg_lib.vigor()
    dims = (cfg.sat_desc_dim,) + tuple(cfg.loc_conv_out)
    return [(batch, (cfg.sat_grid * 2 ** s) ** 2, dims[s], cfg.num_bins)
            for s in range(cfg.num_scales)]


SHAPES = vigor_scales() + [
    (8, 64, 2048, 16), (8, 65536, 32, 16),          # KITTI s1, s6
    (8, 1024, 320, 9),                               # VIGOR ori prior at s3
    (3, 1000, 70, 32), (1, 1, 1, 1), (2, 100, 1280, 4), (1, 130, 88, 20),
]


@pytest.mark.parametrize("b, n, d, k", vigor_scales(), ids=[f"s{i + 1}" for i in range(6)])
def test_vigor_scales_fill_one_wave(b, n, d, k):
    plan = corr_plan(b, n, d, k)
    assert plan.blocks >= corr_cuda.H100_SMS
    assert plan.blocks <= plan.blocks_per_sm * corr_cuda.H100_SMS       # one wave
    assert plan.blocks == plan.grid_x * plan.slices * b


@pytest.mark.parametrize("b, n, d, k", SHAPES)
def test_slices_cover_d_and_tiles_cover_n(b, n, d, k):
    plan = corr_plan(b, n, d, k)
    assert plan.width % 8 == 0 and plan.width >= 8
    assert (plan.slices - 1) * plan.width < d <= plan.slices * plan.width
    tiles = -(-n // plan.rows)
    assert 1 <= plan.grid_x <= tiles
    per_block = -(-tiles // plan.grid_x)
    assert (plan.grid_x - 1) * per_block < tiles <= plan.grid_x * per_block
    assert smem_bytes(plan.width, k, plan.kp) <= corr_cuda.MAX_BLOCK_SMEM
    assert 1 <= plan.blocks_per_sm <= corr_cuda.MAX_BLOCKS_PER_SM
    assert plan.blocks_per_sm * (smem_bytes(plan.width, k, plan.kp)
                                 + corr_cuda.BLOCK_SMEM_RESERVED) <= corr_cuda.SM_SMEM


@pytest.mark.parametrize("k, kp", [(4, 8), (9, 16), (16, 16), (20, 24), (32, 32), (1, 8)])
def test_k_padded_to_the_least_multiple_of_8(k, kp):
    assert corr_plan(8, 4096, 160, k).kp == kp


@pytest.mark.parametrize("k", [0, 33])
def test_plan_rejects_bins_the_kernel_does_not_take(k):
    with pytest.raises(ValueError, match="bins"):
        corr_plan(8, 64, 64, k)


def test_slices_only_where_the_tiles_fall_short_or_d_is_wide():
    for b, n, d, k in vigor_scales():
        tiles = -(-n // corr_cuda.ROWS)
        assert (corr_plan(b, n, d, k).slices > 1) == (b * tiles < corr_cuda.H100_SMS)
    assert corr_plan(8, 64, 160, 20, sms=8).slices == 1       # one block per SM already
    wide = corr_plan(8, 64, 1280, 20, sms=8)                  # G'/M records hold 224 channels
    assert wide.slices == 6 and wide.width == 224


def test_constants_match_the_kernel_source():
    src = (build.CSRC / "corr.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRows") == corr_cuda.ROWS
    assert const("kChunk") == corr_cuda.CHUNK
    assert const("kStages") == corr_cuda.STAGES
    assert const("kMaxBins") == corr_cuda.MAX_BINS
    assert const("kMinBlocks") == corr_cuda.MAX_BLOCKS_PER_SM
    assert const("kMaxSmem") == corr_cuda.MAX_BLOCK_SMEM
    assert "return 4 * kRingFloats + 4 * 3 * kp * (w + 4) + 4 * 2 * kRows * k;" in src
