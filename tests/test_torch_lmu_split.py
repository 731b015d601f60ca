"""The arithmetic of kernel B2 (csrc/lmu.cu::lmu_fwd_kernel) and its
launch rules, on the CPU.

`fused_stage_split_plain` emulates what B2 computes: each conv as one
product with K in the kernel's order, through the 3xTF32 split where the
kernel takes the tensor cores (`tensor_core_conv`). It is held against the
JAX package's fused stage (the Pallas kernel in interpret mode, as
tests/test_lmu_pallas.py runs it, and the jnp reference) at 1e-5 of the
output's max abs: float32 sums in another order, each 3xTF32 product within
~2^-22 of the exact one. On dyadic inputs every product and sum is exact,
so it must give the bits of fused_stage_plain. The launch rules (the fine
tile T, the route of each conv, the n-tiles of an item) are mirrored in
Python and held to the constants of the source. Nothing is compiled or
launched here."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvpe_tpu.ops.lmu_pallas import fused_stage, fused_stage_reference
from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.csrc.build import CSRC
from ccvpe_tpu_torch.ops import lmu_cuda
from ccvpe_tpu_torch.ops.lmu import fused_stage_plain
from ccvpe_tpu_torch.ops.lmu_cuda import (conv_items, conv_tiles, fused_stage_split_plain,
                                          fwd_smem_bytes, fwd_tile, tensor_core_conv)
from ccvpe_tpu_torch.ops.tf32 import round_tf32

REL_TOL = 1e-5

# (b, hc, wc, cin, cd, cskip, c1, cout): ragged in every dimension, with
# and without a skip, Cout 1 (conv_b on the FMAs) and Cout >= 5 (on the
# tensor cores), Cin 9 and 13 (a ragged last k-step), Cd 4 (the deconv on
# the FMAs)
CASES = [(2, 5, 7, 9, 7, 3, 9, 3), (1, 4, 6, 5, 8, 0, 12, 1), (2, 3, 5, 13, 16, 5, 8, 6),
         (1, 3, 4, 6, 4, 2, 5, 7)]
IDS = [f"cin{c[3]}_cd{c[4]}_skip{c[5]}_c1{c[6]}_cout{c[7]}" for c in CASES]


def _case(seed, b, hc, wc, cin, cd, cskip, c1, cout):
    """numpy inputs in JAX layouts: x NHWC, wd (2,2,in,out), convs HWIO."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = mk(b, hc, wc, cin, scale=1.0)
    skip = mk(b, 2 * hc, 2 * wc, cskip, scale=1.0) if cskip else None
    ws = (mk(2, 2, cin, cd, scale=cin ** -0.5), mk(cd, scale=0.3),
          mk(3, 3, cd + cskip, c1, scale=(9 * (cd + cskip)) ** -0.5), mk(c1, scale=0.3),
          mk(3, 3, c1, cout, scale=(9 * c1) ** -0.5), mk(cout, scale=0.3))
    return x, skip, ws


def _torch_weights(ws):
    """JAX layouts -> torch's: deconv (in,out,2,2), conv OIHW."""
    wd, bd, w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(w)) for w in ws)
    return (wd.permute(2, 3, 0, 1), bd, w1.permute(3, 2, 0, 1), b1, w2.permute(3, 2, 0, 1), b2)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_emulation_matches_the_jax_fused_stage(case):
    x, skip, ws = _case(1, *case)
    jws = [jnp.asarray(w) for w in ws]
    pallas = np.asarray(fused_stage(_j(x), _j(skip), *jws, interpret=True))
    ref = np.asarray(fused_stage_reference(_j(x), _j(skip), *jws))
    out = fused_stage_split_plain(_t(x), _t(skip), *_torch_weights(ws)).numpy()
    assert out.shape == pallas.shape == ref.shape
    for want in (pallas, ref):
        assert np.abs(out - want).max() <= REL_TOL * np.abs(want).max()


def _dyadic(seed, b, hc, wc, cin, cd, cskip, c1, cout):
    """Small multiples of 1/4 .. 1/16 (as chip_smoke.lmu_inputs makes them):
    TF32 holds each exactly (lo = 0), and every product and sum of the stage
    is exact in float32, in any order."""
    g = torch.Generator().manual_seed(seed)

    def mk(*size, lim, den):
        return torch.randint(-lim, lim + 1, size, generator=g).float() / den

    x = mk(b, hc, wc, cin, lim=8, den=4)
    skip = mk(b, 2 * hc, 2 * wc, cskip, lim=8, den=4) if cskip else None
    ws = (mk(cin, cd, 2, 2, lim=4, den=8), mk(cd, lim=4, den=8),
          mk(c1, cd + cskip, 3, 3, lim=4, den=16), mk(c1, lim=4, den=8),
          mk(cout, c1, 3, 3, lim=4, den=8), mk(cout, lim=4, den=8))
    return x, skip, ws


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_emulation_is_exact_on_dyadic_inputs(case):
    x, skip, ws = _dyadic(2, *case)
    assert torch.equal(fused_stage_split_plain(x, skip, *ws), fused_stage_plain(x, skip, *ws))


def _stage64(x, skip, wd, bd, w1, b1, w2, b2):
    """The stage in float64, NHWC in and out."""
    import torch.nn.functional as F
    h = F.conv_transpose2d(x.permute(0, 3, 1, 2).double(), wd.double(), bd.double(), stride=2)
    if skip is not None:
        h = torch.cat([h, skip.permute(0, 3, 1, 2).double()], dim=1)
    g = F.relu(F.conv2d(h, w1.double(), b1.double(), padding=1))
    return F.conv2d(g, w2.double(), b2.double(), padding=1).permute(0, 2, 3, 1)


def test_split_emulation_rounds_differently_from_one_tf32_product():
    """The emulation takes three TF32 products where the kernel does: it
    lands within 1e-5 of float64, inputs rounded once to TF32 ~1e-4 away."""
    x, skip, ws = _case(3, *CASES[2])
    args = (_t(x), _t(skip)) + _torch_weights(ws)
    exact = _stage64(*args)
    scale = float(exact.abs().max())
    got = fused_stage_split_plain(*args).double()
    assert float((got - exact).abs().max()) <= REL_TOL * scale
    crude = _stage64(*(round_tf32(t.contiguous()) for t in args))
    assert float((crude - exact).abs().max()) > 10 * REL_TOL * scale


def vigor_calls(batch=8):
    """(Cin, Cs, Cd, C1, Cout) of the four fused calls of a VIGOR train step
    at lmu_fused_min_res=256 (chip_smoke.lmu_call_shapes)."""
    cfg = cfg_lib.vigor()
    return {"loc stage 5": (cfg.loc_conv_out[3] + 1, 16, cfg.loc_deconv_out[4],
                            cfg.loc_conv_out[4], cfg.loc_conv_out[4]),
            "ori stage 5": (cfg.ori_conv_out[3], 16, cfg.ori_deconv_out[4],
                            cfg.ori_conv_out[4], cfg.ori_conv_out[4]),
            "loc stage 6+head": (cfg.loc_conv_out[4] + 1, 0, cfg.loc_deconv_out[5],
                                 cfg.head_hidden, 1),
            "ori stage 6+head": (cfg.ori_conv_out[4], 0, cfg.ori_deconv_out[5],
                                 cfg.head_hidden, 2)}


def test_vigor_calls_take_t16_and_t8_fits():
    calls = vigor_calls()
    assert calls["loc stage 5"] == (81, 16, 40, 40, 40)
    assert fwd_smem_bytes(*calls["loc stage 5"], 16) == 222976
    assert fwd_smem_bytes(*calls["loc stage 5"], 8) == 154240
    for shape in calls.values():
        assert fwd_tile(*shape) == 16
        assert fwd_smem_bytes(*shape, 8) < fwd_smem_bytes(*shape, 16) <= lmu_cuda.MAX_BLOCK_SMEM


def test_fwd_tile_falls_back_to_smaller_tiles_then_raises():
    shape = (81, 16, 40, 40, 40)
    assert fwd_tile(*shape, limit=222975) == 8
    assert fwd_tile(*shape, limit=154239) == 4
    with pytest.raises(ValueError, match="tile"):
        fwd_tile(*shape, limit=1000)


@pytest.mark.parametrize("cout, tc", [(1, False), (2, False), (4, False), (5, True), (16, True),
                                      (40, True)])
def test_route_by_output_channels(cout, tc):
    assert tensor_core_conv(cout) is tc


def test_vigor_routes_and_items():
    """Every VIGOR conv on the tensor cores but the heads' conv_b; items of
    5, 4 and 2 n-tiles for 40, 32 and 16 channels; at loc stage 5 the
    forward (two m-tiles an item, T = 16) takes conv_a's 18^2 box in 11
    items, conv_b's 16^2 in 8 and each deconv phase's 10^2 in 4; the
    backward's recompute (one m-tile, T = 8) conv_a's 10^2 box in 7."""
    for name, (cin, cs, cd, c1, cout) in vigor_calls().items():
        assert tensor_core_conv(cd) and tensor_core_conv(c1)
        assert tensor_core_conv(cout) == ("head" not in name)
    assert [conv_tiles(n) for n in (40, 32, 16, 12, 7)] == [5, 4, 2, 2, 1]
    assert (lmu_cuda.FWD_MTILES, lmu_cuda.BWD_MTILES) == (2, 1)
    assert conv_items(18, 40) == 11 and conv_items(16, 40) == 8 and conv_items(10, 40) == 4
    assert conv_items(10, 40, lmu_cuda.BWD_MTILES) == 7
    assert conv_items(18, 16) == 11                # the heads' conv_a, n-tiles of 2


def test_mma_count_at_loc_stage_5():
    """Per T = 16 tile, m-tiles rounded up to pairs: deconv 4 x 8 x 11 x 5
    x 3, conv_a 22 x 9 x 7 x 5 x 3, conv_b 16 x 9 x 5 x 5 x 3; 2048 tiles
    at batch 8; the heads' conv_b (Cout 1) issues none."""
    assert lmu_cuda.fwd_mma_count(1, 8, 8, 81, 16, 40, 40, 40, 16) == 5280 + 20790 + 10800
    assert lmu_cuda.fwd_mma_count(8, 128, 128, 81, 16, 40, 40, 40, 16) == 2048 * 36870
    head = lmu_cuda.fwd_mma_count(1, 8, 8, 41, 0, 16, 16, 1, 16)
    assert head == 4 * 8 * 6 * 2 * 3 + 22 * 9 * 2 * 2 * 3


def test_rules_match_the_kernel_source():
    src = (CSRC / "lmu.cu").read_text()
    assert "return (side * side + 3) / 8 * 8 + 4;" in src
    assert "return c <= 4 ? 4 : (c + 7) / 8 * 8;" in src
    assert "if (pad_co(cout) % 8 == 0)" in src
    assert "return tiles % 5 == 0 ? 5 : tiles % 4 == 0 ? 4 : tiles % 2 == 0 ? 2 : 1;" in src
    assert "for (int t : {16, 8, 4})" in src
    assert "constexpr int kFwdMTiles = 2;" in src and "constexpr int kBwdMTiles = 1;" in src
    assert tuple(lmu_cuda.FWD_TILES) == (16, 8, 4)
    body = re.search(r"FwdLayout fwd_layout\(const Dims& d\) \{(.*?)\n\}", src, re.S).group(1)
    for line in ("const int a = imax(c * plane_stride(hs), 9 * d.c1 * pad_co(d.cout));",
                 "const int b = imax(d.c1 * plane_stride(gs), d.cin * plane_stride(xs));",
                 "const int w = imax(4 * d.cin * pad_co(d.cd), 9 * c * pad_co(d.c1));"):
        assert line in body


@pytest.mark.parametrize("tile", [3, 32, -1])
def test_fused_stage_rejects_other_tiles(tile):
    x, skip, ws = _case(4, *CASES[0])
    with pytest.raises(ValueError, match="tile"):
        lmu_cuda.fused_stage(_t(x), _t(skip), *_torch_weights(ws), tile=tile)


@pytest.mark.parametrize("tile", [0, 16, 8, 4])
def test_fused_stage_on_cpu_is_the_plain_version_at_any_tile(tile):
    x, skip, ws = _case(5, *CASES[0])
    tws = _torch_weights(ws)
    before = lmu_cuda.fused_stage.launches
    got = lmu_cuda.fused_stage(_t(x), _t(skip), *tws, tile=tile)
    assert torch.equal(got, fused_stage_plain(_t(x), _t(skip), *tws))
    assert lmu_cuda.fused_stage.launches == before


def test_mma_rate_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py measures the rate there")
    with pytest.raises(ValueError, match="card"):
        lmu_cuda.mma_rate()
