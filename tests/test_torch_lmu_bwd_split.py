"""The arithmetic of kernel B3 (csrc/lmu.cu::lmu_bwd_kernel) and the rules of
its own convs (da, dh|dskip, dx), on the CPU.

`fused_stage_bwd_split_plain` emulates what B3 computes: h and g recomputed
as B2 computes them, each of da, dh|dskip and dx as one product with K in
the kernel's order, through the 3xTF32 split where the kernel takes the
tensor cores (`bwd_tensor_core_conv`), and the weight gradients in 3xTF32.
It is held against the JAX package's fused backward (the Pallas kernel in
interpret mode, as tests/test_torch_lmu.py runs it) at 1e-5 of each
gradient's max abs: float32 sums in another order, each 3xTF32 product
within ~2^-22 of the exact one. On dyadic inputs and a dyadic dy every
product and sum is exact, so it must give the bits of fused_stage_bwd_plain.
The route, the n-grouping, the items and the mma.sync count of B3 are
mirrored in Python and held to the source. Nothing is compiled or launched
here."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvpe_tpu.ops.lmu_pallas import fused_stage_bwd_pallas
from ccvpe_tpu_torch.csrc.build import CSRC
from ccvpe_tpu_torch.ops import lmu_cuda
from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain
from ccvpe_tpu_torch.ops.lmu_cuda import (bwd_conv_items, bwd_conv_tiles, bwd_convs,
                                          bwd_mma_count, bwd_mma_per_tile, bwd_tensor_core_conv,
                                          fused_stage_bwd_split_plain)
from ccvpe_tpu_torch.ops.tf32 import round_tf32
from tests.test_torch_lmu_split import vigor_calls

REL_TOL = 1e-5
NAMES = ("dx", "dskip", "dwd", "dbd", "dw1", "db1", "dw2", "db2")

# (b, hc, wc, cin, cd, cskip, c1, cout): ragged in every dimension; with and
# without a skip; Cout 1 and 3 (da on the FMAs) and Cout 6 with C1 24 (da on
# the tensor cores, one ragged k-step a tap); Cin 83 and C1 13 and 24
# (ragged last k-steps of dx's phases and of dh|dskip); [dh | dskip] of 56
# channels (7 n-tiles, a ragged last group of 2) and dx of 83 (11 n-tiles),
# VIGOR loc stage 5's counts; a case with every conv of B3 on the FMAs
CASES = [(2, 5, 7, 9, 7, 3, 9, 3), (1, 4, 6, 5, 8, 0, 12, 1), (2, 3, 5, 13, 16, 5, 24, 6),
         (1, 3, 4, 83, 40, 16, 13, 6), (1, 2, 3, 7, 6, 0, 5, 7)]
IDS = [f"cin{c[3]}_cd{c[4]}_skip{c[5]}_c1{c[6]}_cout{c[7]}" for c in CASES]


def _case(seed, b, hc, wc, cin, cd, cskip, c1, cout):
    """numpy inputs in JAX layouts: x NHWC, wd (2,2,in,out), convs HWIO; dy."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = mk(b, hc, wc, cin, scale=1.0)
    skip = mk(b, 2 * hc, 2 * wc, cskip, scale=1.0) if cskip else None
    ws = (mk(2, 2, cin, cd, scale=cin ** -0.5), mk(cd, scale=0.3),
          mk(3, 3, cd + cskip, c1, scale=(9 * (cd + cskip)) ** -0.5), mk(c1, scale=0.3),
          mk(3, 3, c1, cout, scale=(9 * c1) ** -0.5), mk(cout, scale=0.3))
    dy = mk(b, 2 * hc, 2 * wc, cout, scale=1.0)
    return x, skip, ws, dy


def _torch_weights(ws):
    """JAX layouts -> torch's: deconv (in,out,2,2), conv OIHW."""
    wd, bd, w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(w)) for w in ws)
    return (wd.permute(2, 3, 0, 1), bd, w1.permute(3, 2, 0, 1), b1, w2.permute(3, 2, 0, 1), b2)


def _to_jax_layout(grads):
    """(dx, dskip, dwd, dbd, dw1, db1, dw2, db2) torch layouts -> JAX's."""
    dx, dskip, dwd, dbd, dw1, db1, dw2, db2 = (None if g is None else g.numpy() for g in grads)
    return (dx, dskip, dwd.transpose(2, 3, 0, 1), dbd, dw1.transpose(2, 3, 1, 0), db1,
            dw2.transpose(2, 3, 1, 0), db2)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_split_emulation_matches_the_jax_backward(case):
    x, skip, ws, dy = _case(11, *case)
    want = fused_stage_bwd_pallas(_j(x), _j(skip), jnp.asarray(dy), *[jnp.asarray(w) for w in ws],
                                  interpret=True)
    got = _to_jax_layout(fused_stage_bwd_split_plain(_t(x), _t(skip), torch.from_numpy(dy),
                                                     *_torch_weights(ws)))
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, name
            continue
        w = np.asarray(w)
        assert a.shape == w.shape, name
        assert np.abs(a - w).max() <= REL_TOL * np.abs(w).max(), name


def _dyadic(seed, b, hc, wc, cin, cd, cskip, c1, cout):
    """Small multiples of 1/4 .. 1/16 (as chip_smoke.lmu_inputs makes them)
    and a dy of multiples of 1/4: every product and sum of the backward is
    exact in float32, in any order, and the 3xTF32 split of each operand is
    exact (hi + lo), so the dropped lo*lo term vanishes where one side is
    TF32 already."""
    g = torch.Generator().manual_seed(seed)

    def mk(*size, lim, den):
        return torch.randint(-lim, lim + 1, size, generator=g).float() / den

    x = mk(b, hc, wc, cin, lim=8, den=4)
    skip = mk(b, 2 * hc, 2 * wc, cskip, lim=8, den=4) if cskip else None
    ws = (mk(cin, cd, 2, 2, lim=4, den=8), mk(cd, lim=4, den=8),
          mk(c1, cd + cskip, 3, 3, lim=4, den=16), mk(c1, lim=4, den=8),
          mk(cout, c1, 3, 3, lim=4, den=8), mk(cout, lim=4, den=8))
    dy = mk(b, 2 * hc, 2 * wc, cout, lim=4, den=4)
    return x, skip, dy, ws


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_split_emulation_is_exact_on_dyadic_inputs(case):
    x, skip, dy, ws = _dyadic(12, *case)
    got = fused_stage_bwd_split_plain(x, skip, dy, *ws)
    want = fused_stage_bwd_plain(x, skip, dy, *ws)
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            assert a is None, name
        else:
            assert torch.equal(a, w), name


def _dx64(x, skip, dy, wd, bd, w1, b1, w2, b2):
    """dx of the stage in float64, by autograd, NHWC."""
    import torch.nn.functional as F
    x = x.double().requires_grad_()
    h = F.conv_transpose2d(x.permute(0, 3, 1, 2), wd.double(), bd.double(), stride=2)
    if skip is not None:
        h = torch.cat([h, skip.permute(0, 3, 1, 2).double()], dim=1)
    g = F.relu(F.conv2d(h, w1.double(), b1.double(), padding=1))
    y = F.conv2d(g, w2.double(), b2.double(), padding=1).permute(0, 2, 3, 1)
    return torch.autograd.grad(y, x, dy.double())[0]


def test_bwd_split_emulation_rounds_differently_from_one_tf32_product():
    """Where B3 takes the tensor cores it takes three TF32 products: dx lands
    within 1e-5 of float64, and the same stage on operands rounded once to
    TF32 ~1e-4 away."""
    b, hc, wc, cin, cd, cskip, c1, cout = CASES[3]
    x, skip, ws, dy = _case(13, *CASES[3])
    args = (_t(x), _t(skip), torch.from_numpy(dy)) + _torch_weights(ws)
    assert bwd_tensor_core_conv(cin, cd)
    got = fused_stage_bwd_split_plain(*args)[0].double()
    exact = _dx64(*args)
    scale = float(exact.abs().max())
    assert float((got - exact).abs().max()) <= REL_TOL * scale
    crude = _dx64(*(None if t is None else round_tf32(t.contiguous()) for t in args))
    assert float((crude - exact).abs().max()) > 10 * REL_TOL * scale


@pytest.mark.parametrize("n, k, tc", [(40, 40, True), (16, 1, False), (16, 2, False),
                                      (16, 16, False), (17, 5, True), (24, 4, False),
                                      (24, 5, True), (5, 40, False), (81, 40, True),
                                      (41, 16, True), (32, 16, True)])
def test_bwd_route_by_output_and_input_channels(n, k, tc):
    """The tensor cores where n spans 3 or more n-tiles and k fills at
    least 5 of a k-step's 8 channels."""
    assert bwd_tensor_core_conv(n, k) is tc


@pytest.mark.parametrize("n, side, nt", [(40, 10, 4), (32, 10, 2), (16, 10, 1), (56, 8, 2),
                                         (48, 8, 2), (16, 8, 1), (81, 4, 1), (64, 4, 1),
                                         (129, 4, 2), (40, 6, 2), (24, 6, 1), (8, 10, 1)])
def test_bwd_conv_tiles(n, side, nt):
    """4, else 2, the wider that leaves at least BWD_CONV_ITEMS items over
    the box's m-tiles (a ragged last group allowed), else 1; never more than
    the tiles."""
    assert bwd_conv_tiles(n, side) == nt
    assert nt <= -(-n // 8)
    assert bwd_conv_items(side, n) >= lmu_cuda.BWD_CONV_ITEMS or nt == 1
    mtiles, tiles = -(-side * side // 16), -(-n // 8)
    for wider in (4, 2):
        if wider > nt and tiles >= wider:
            assert mtiles * -(-tiles // wider) < lmu_cuda.BWD_CONV_ITEMS


def test_vigor_bwd_routes_and_items():
    """At T = 8: every VIGOR backward conv on the tensor cores but the
    heads' da (K = Cout 1 or 2) and dh|dskip (N = 16); at loc stage 5 da's
    10^2 box in 7 x 2 items of 4 n-tiles (the last ragged), dh|dskip's 8^2
    in 4 x 4 items of 2 (the last ragged), dx's 4^2 coarse box in 11 items
    of 1; at the loc head dx in 6."""
    for name, shape in vigor_calls().items():
        for conv, (side, k, n, taps) in bwd_convs(*shape, 8).items():
            assert bwd_tensor_core_conv(n, k) == (conv == "dx" or "head" not in name), (name, conv)
    convs = bwd_convs(*vigor_calls()["loc stage 5"], 8)
    assert convs == {"da": (10, 40, 40, 9), "dh|dskip": (8, 40, 56, 9), "dx": (4, 40, 81, 4)}
    assert [bwd_conv_tiles(n, side) for side, _, n, _ in convs.values()] == [4, 2, 1]
    assert [bwd_conv_items(side, n) for side, _, n, _ in convs.values()] == [14, 16, 11]
    assert lmu_cuda.BWD_MTILES == 1
    side, _, n, _ = bwd_convs(*vigor_calls()["loc stage 6+head"], 8)["dx"]
    assert bwd_conv_items(side, n) == 6


# mma.sync per T = 8 tile at the four VIGOR calls, by part
VIGOR_MMA = {
    "loc stage 5": dict(deconv=1980, conv_a=6615, dw2=3240, dw1=4320, dwd=720, da=7560,
                        **{"dh|dskip": 4320}, dx=660),
    "ori stage 5": dict(deconv=1152, conv_a=4536, dw2=1728, dw1=2592, dwd=384, da=3024,
                        **{"dh|dskip": 2592}, dx=384),
    "loc stage 6+head": dict(deconv=432, conv_a=756, dw2=216, dw1=432, dwd=144, da=0,
                             **{"dh|dskip": 0}, dx=144),
    "ori stage 6+head": dict(deconv=288, conv_a=756, dw2=216, dw1=432, dwd=96, da=0,
                             **{"dh|dskip": 0}, dx=96),
}


@pytest.mark.parametrize("name", list(VIGOR_MMA))
def test_bwd_mma_count_at_the_vigor_calls(name):
    """Per T = 8 tile: loc stage 5's da 14 items x 9 taps x 5 k-steps x 4
    n-tiles x 3 (the ragged group repeats 3 of the 5 n-tiles), dh|dskip
    16 x 9 x 5 x 2 x 3, ori stage 5's da 14 x 9 x 4 x 2 x 3, dx 11 x 4 x 5 x
    1 x 3, conv_a 7 x 9 x 7 x 5 x 3 as in B2; batch 8 at 256^2 (stage 5)
    or 512^2 fine pixels: 8192 or 32768 tiles."""
    shape = vigor_calls()[name]
    assert bwd_mma_per_tile(*shape, 8) == VIGOR_MMA[name]
    hc = 128 if "stage 5" in name else 256
    tiles = 8 * (2 * hc // 8) ** 2
    assert bwd_mma_count(8, hc, hc, *shape, 8) == tiles * sum(VIGOR_MMA[name].values())


def test_bwd_rules_match_the_kernel_source():
    src = (CSRC / "lmu.cu").read_text()
    assert "return pad_co(n) >= 24 && pad_co(k) % 8 == 0;" in src
    body = re.search(r"inline int bwd_conv_tiles\(int n, int mtiles\) \{(.*?)\n\}", src,
                     re.S).group(1)
    items = f"constexpr int kBwdConvItems = {lmu_cuda.BWD_CONV_ITEMS};"
    assert items in src
    for line in ("const int tiles = (n + 7) / 8;",
                 "if (tiles >= 4 && mtiles * ((tiles + 3) / 4) >= kBwdConvItems) return 4;",
                 "if (tiles >= 2 && mtiles * ((tiles + 1) / 2) >= kBwdConvItems) return 2;",
                 "return 1;"):
        assert line in body
    # the backward's dispatcher offers the three groupings the rule returns
    body = re.search(r"__device__ int bwd_conv_tc\(.*?\n\}", src, re.S).group(0)
    assert re.findall(r"case (\d): return CCVPE_CONV_TC", body) == ["4", "2"]
    assert "default: return CCVPE_CONV_TC(1);" in body
    assert "bwd_conv_tiles(cout, (out_side * out_side + 16 * MT - 1) / (16 * MT))" in src
    assert "const int n0 = imin(n_own, (ntiles - NT) * 8);" in src
    assert "if (mn.x < npos && mn.y >= n_own && mn.y < cout)" in src
    assert "constexpr int kBwdMTiles = 1;" in src
    body = re.search(r"lmu_bwd_kernel\(Dims d.*?\n\}\n", src, re.S).group(0)
    # the three convs, routed by the shape alone, with their K per tap and N
    assert "if (bwd_tensor_core(d.c1, d.cout))" in body
    assert "bwd_tensor_core(c, d.c1)" in body
    assert "if (bwd_tensor_core(cin, cd))" in body
    assert "bwd_conv_tc<9, kBwdMTiles>(s_dy, d.cout, hps, hs, 1, SquareTaps<3>{hs}" in body
    assert "bwd_conv_tc<9, kBwdMTiles>(s_da, d.c1, gps, gs, 1, SquareTaps<3>{gs}" in body
    assert "bwd_conv_tc<4, kBwdMTiles>(s_dh, cd, dps, t, 2, phase," in body
    assert "return (ph / 2) * t + ph % 2;" in body


def test_fused_stage_bwd_on_cpu_is_the_plain_version():
    x, skip, ws, dy = _case(14, *CASES[0])
    tws = _torch_weights(ws)
    before = lmu_cuda.fused_stage_bwd.launches
    got = lmu_cuda.fused_stage_bwd(_t(x), _t(skip), torch.from_numpy(dy), *tws)
    want = fused_stage_bwd_plain(_t(x), _t(skip), torch.from_numpy(dy), *tws)
    assert all(torch.equal(a, w) for a, w in zip(got, want) if w is not None)
    assert lmu_cuda.fused_stage_bwd.launches == before
