"""The arithmetic, launch rules and index maps of the bf16 kernels B2 and B3
(csrc/lmu_bf16.cu), on the CPU.

`fused_stage_bf16_split_plain` and `fused_stage_bwd_bf16_split_plain`
emulate what the kernels compute: every conv on bf16 values with K in the
kernels' order (tap by tap, k-steps of 16 channels with float32 sums), the
roundings where the kernels round. They are held against the JAX package's
Pallas kernels on bf16 inputs in interpret mode (as
tests/test_torch_lmu_bf16.py runs them) within ULPS bf16 ulps of each
output's largest magnitude, that file's tolerance: both round h, conv_a, da,
dh, dx and dskip to bf16 after float32 sums taken in another order, so a
value within roundoff of a rounding tie lands one ulp apart. On dyadic
inputs every product and sum is exact, so they give the bits of ops/lmu.py's
bf16 plain versions.

The kernels' shared-memory plans are mirrored in Python (B3 takes T = 16 at
the VIGOR calls) and held to the source with their constants, and a numpy
rehearsal of the kernels' pixel-major planes, ldmatrix fragment maps and
mma.sync.m16n8k16 fragments (conv_tc, wgrad_tc, the probe) is held
against the plain product. Nothing is compiled or launched here."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvpe_tpu.ops.lmu_pallas import fused_stage, fused_stage_bwd_pallas
from ccvpe_tpu_torch.csrc.build import CSRC
from ccvpe_tpu_torch.ops import lmu_cuda
from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain
from ccvpe_tpu_torch.ops.lmu_cuda import (BF16_TILES, MAX_BLOCK_SMEM, WEIGHT_MODES,
                                          bf16_bwd_smem_bytes, bf16_bwd_tile,
                                          bf16_fwd_smem_bytes, bf16_fwd_tile,
                                          fused_stage_bf16_split_plain,
                                          fused_stage_bwd_bf16_split_plain, n_group, pix_stride)
from test_torch_lmu import _to_jax_layout, _torch_weights
from test_torch_lmu_bf16 import CASES, IDS, NAMES, ULPS, _bf16, _inputs, _j16, _t16, assert_ulps
from test_torch_lmu_bwd_split import _case as _bwd_case
from tests.test_torch_lmu_split import vigor_calls

SRC = CSRC / "lmu_bf16.cu"
KITTI_CALLS = {"loc stage 5": (129, 16, 32, 32, 32), "ori stage 5": (64, 16, 32, 32, 32),
               "loc stage 6+head": (33, 0, 16, 16, 1), "ori stage 6+head": (32, 0, 16, 16, 2)}


# --- the emulation against the Pallas kernels -----------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_split_forward_matches_pallas(case):
    x, skip, ws, strip = _inputs(case, 0)
    want = fused_stage(_j16(x), _j16(skip), *[jnp.asarray(w) for w in ws], strip=strip,
                       interpret=True)
    got = fused_stage_bf16_split_plain(_t16(x), _t16(skip), *_torch_weights(ws))
    assert got.dtype == torch.float32
    assert_ulps(got.numpy(), np.asarray(want), "y")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_split_backward_matches_pallas(case):
    x, skip, ws, strip = _inputs(case, 7)
    b, hc, wc, *_, cout, _ = case
    dy = (np.random.default_rng(8).normal(size=(b, 2 * hc, 2 * wc, cout)) * 0.3).astype(np.float32)
    want = fused_stage_bwd_pallas(_j16(x), _j16(skip), jnp.asarray(dy),
                                  *[jnp.asarray(w) for w in ws], strip=strip, interpret=True)
    grads = fused_stage_bwd_bf16_split_plain(_t16(x), _t16(skip), torch.from_numpy(dy),
                                             *_torch_weights(ws))
    assert grads[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads[2:])
    got = _to_jax_layout([None if g is None else g.float() for g in grads])
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None and not case[5]
            continue
        assert_ulps(g, np.asarray(w.astype(jnp.float32)), name)


# (b, hc, wc, cin, cd, cskip, c1, cout): ragged in every dimension, with and
# without a skip, a K of 83 and 21 channels (ragged last k-steps of 16), a
# [dh | dskip] of 56 (7 n-tiles in groups of 4) and a dx of 83 (11 n-tiles)
DYADIC = [(2, 5, 7, 9, 7, 3, 9, 3), (1, 4, 6, 5, 8, 0, 12, 1), (1, 3, 4, 83, 40, 16, 21, 6)]


def _dyadic(seed, shape):
    """Small multiples of 1/4 .. 1/16 (bf16 values; every sum exact in float32)."""
    x, skip, ws, dy = _bwd_case(seed, *shape)
    rng = np.random.default_rng(seed + 100)

    def dyadic(a, den):
        return None if a is None else (np.round(a * den) / den).astype(np.float32)

    ws = tuple(dyadic(w, 16) for w in ws)
    return (dyadic(x, 4), dyadic(skip, 4), ws,
            (rng.integers(-4, 5, dy.shape) / 4).astype(np.float32))


@pytest.mark.parametrize("shape", DYADIC)
def test_bf16_split_is_exact_on_dyadic_inputs(shape):
    x, skip, ws, dy = _dyadic(3, shape)
    tw = _torch_weights(ws)
    y = fused_stage_bf16_split_plain(_t16(x), _t16(skip), *tw)
    assert torch.equal(y, fused_stage_plain(_t16(x), _t16(skip), *tw))
    got = fused_stage_bwd_bf16_split_plain(_t16(x), _t16(skip), torch.from_numpy(dy), *tw)
    want = fused_stage_bwd_plain(_t16(x), _t16(skip), torch.from_numpy(dy), *tw)
    for name, g, w in zip(NAMES, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), name


# --- the plans ------------------------------------------------------------

def test_bf16_plans_take_t16_at_the_vigor_and_kitti_calls():
    """B3 (planes and one weight buffer) and B2 fit T = 16 in a block's
    232,448 bytes at the four VIGOR and four KITTI calls."""
    calls = {**vigor_calls(), **{"kitti " + k: v for k, v in KITTI_CALLS.items()}}
    assert len(calls) == 8
    for name, shape in calls.items():
        assert bf16_bwd_tile(*shape) == 16, name
        assert bf16_bwd_smem_bytes(*shape, 16) <= MAX_BLOCK_SMEM, name
        assert bf16_fwd_tile(*shape) == 16, name
    # loc stage 5: the reckoning of the design (planes ~166 KB, one w1T buffer)
    assert bf16_bwd_smem_bytes(*vigor_calls()["loc stage 5"], 16) == 2 * (
        104 + 400 * 56 + 8 + 324 * 40 + 8 + 400 * 40 + 8 + 324 * 40 + 8 + 100 * 88 + 8
        + 256 * 40 + 8 + 1280 + 9 * 40 * 56)


def test_bf16_bwd_plan_falls_back_to_smaller_tiles_then_raises():
    shape = (29, 5, 53, 65, 21)             # chip_smoke.py's "tensor cores at T 4" widths
    assert bf16_bwd_tile(*shape) == 8
    assert bf16_bwd_smem_bytes(*shape, 16) > MAX_BLOCK_SMEM
    assert bf16_bwd_tile(*shape, limit=bf16_bwd_smem_bytes(*shape, 4)) == 4
    with pytest.raises(ValueError):
        bf16_bwd_tile(*shape, limit=1000)
    sizes = [bf16_bwd_smem_bytes(*shape, 8, w) for w in WEIGHT_MODES]
    assert sizes[0] < sizes[1] and bf16_bwd_smem_bytes(*shape, 8, ahead=True) > sizes[0]
    # chip_smoke.py's "bf16 B3 at T 4" case: T = 8 passes the limit, T = 4 fits, B2 fits
    t4 = (13, 5, 69, 101, 21)
    assert bf16_bwd_tile(*t4) == 4 and bf16_bwd_smem_bytes(*t4, 8) > MAX_BLOCK_SMEM
    assert bf16_fwd_tile(*t4) in BF16_TILES


def test_pix_stride_is_odd_16_byte_units():
    for c in range(1, 200):
        s = pix_stride(c)
        assert s >= c and s % 8 == 0 and (s // 8) % 2 == 1 and s - c < 16
    assert [pix_stride(c) for c in (1, 16, 40, 56, 81, 32, 48)] == [8, 24, 40, 56, 88, 40, 56]


@pytest.mark.parametrize("n,nt", [(1, 1), (16, 2), (40, 5), (48, 3), (56, 4), (81, 4), (131, 5)])
def test_n_group(n, nt):
    assert n_group(n) == nt
    tiles = -(-n // 8)
    assert nt <= tiles and -(-tiles // nt) == -(-tiles // 5)


def test_bf16_rules_match_the_kernel_source():
    src = SRC.read_text()
    assert "return (c + 7) / 8 % 2 ? (c + 7) / 8 * 8 : (c + 7) / 8 * 8 + 8;" in src
    assert "tiles = (n + 7) / 8, groups = (tiles + 4) / 5;" in src
    assert "return (tiles + groups - 1) / groups;" in src
    assert "return npix * pix_stride(c) + 8;" in src
    assert int(re.search(r"kBwdThreads = (\d+);", src).group(1)) == lmu_cuda.BF16_BWD_THREADS
    assert int(re.search(r"kFwdMTiles = (\d+);", src).group(1)) == lmu_cuda.BF16_FWD_MTILES
    assert "constexpr int bwd_mtiles(int nt) { return nt <= 3 ? 2 : 1; }" in src
    assert [lmu_cuda.bf16_bwd_mtiles(nt) for nt in range(1, 6)] == [2, 2, 2, 1, 1]
    assert max(n_group(n) for n in range(1, 400)) == 5 and "case 5:" in src
    for m in re.finditer(r"for \(int t : \{([\d, ]+)\}\)", src):
        assert tuple(int(v) for v in m.group(1).split(",")) == BF16_TILES
    assert len(re.findall(r"for \(int t : \{", src)) == 2
    body = re.search(r"enum BwdPhase \{([^}]*)\}", src).group(1)
    lmu = re.search(r"enum BwdPhase \{([^}]*)\}", (CSRC / "lmu.cu").read_text()).group(1)
    assert body.split() == lmu.split()
    # every conv takes the tensor cores: no FMA conv in the bf16 source
    assert "tile_conv(" not in src and "fmaf" not in src
    assert "mma_bf16(" in src and "mma_3xtf32" not in src


def test_bf16_wrappers_on_cpu_take_the_plain_versions():
    x, skip, ws, _ = _inputs(CASES[0], 4)
    tw = _torch_weights(ws)
    before = (lmu_cuda.fused_stage.bf16_launches, lmu_cuda.fused_stage_bwd.bf16_launches,
              lmu_cuda.mma_probe.launches)
    y = lmu_cuda.fused_stage(_t16(x), _t16(skip), *tw)
    assert torch.equal(y, fused_stage_plain(_t16(x), _t16(skip), *tw))
    a = torch.randn(5, 21).bfloat16()
    b = torch.randn(21, 3).bfloat16()
    assert torch.equal(lmu_cuda.mma_probe(a, b), a.float() @ b.float())
    assert before == (lmu_cuda.fused_stage.bf16_launches, lmu_cuda.fused_stage_bwd.bf16_launches,
                      lmu_cuda.mma_probe.launches)


# --- a numpy rehearsal of the kernels' shared-memory index maps ------------
#
# Shared memory is a flat array of bf16 values (float32 here); addresses are
# element offsets. ldmatrix and mma.sync.m16n8k16 follow the fragment maps of
# csrc/tf32_mma.cuh's bf16 section (the PTX ISA's); conv_tc, wgrad_tc
# and the probe follow csrc/lmu_bf16.cu line by line.

def _ldsm(mem, addrs, nmat=4, trans=False):
    """regs [32, nmat, 2]: lane l's register j = matrix j's row l // 4,
    columns 2(l % 4), +1 (trans: rows 2(l % 4), +1 at column l // 4); row r
    of matrix j at the address of lane 8j + r."""
    mats = np.stack([np.stack([mem[addrs[8 * j + r]:addrs[8 * j + r] + 8] for r in range(8)])
                     for j in range(nmat)])
    lanes = np.arange(32)
    g, q = lanes // 4, lanes % 4
    if trans:
        mats = mats.transpose(0, 2, 1)
    return np.stack([np.stack([mats[j, g, 2 * q], mats[j, g, 2 * q + 1]], -1)
                     for j in range(nmat)], 1)


def _mma(acc, a, b):
    """acc [32, 4] += D of A (a [32, 4, 2]) B (b [32, 2, 2]), m16n8k16."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for e in range(2):
            A[g, 2 * q + e], A[g + 8, 2 * q + e] = a[lane, 0, e], a[lane, 1, e]
            A[g, 8 + 2 * q + e], A[g + 8, 8 + 2 * q + e] = a[lane, 2, e], a[lane, 3, e]
            B[2 * q + e, g], B[8 + 2 * q + e, g] = b[lane, 0, e], b[lane, 1, e]
    d = A @ B
    g, q = np.arange(32) // 4, np.arange(32) % 4
    acc += np.stack([d[g, 2 * q], d[g, 2 * q + 1], d[g + 8, 2 * q], d[g + 8, 2 * q + 1]], -1)


def _entry(e, m0, n0):
    lane = np.arange(32)
    return m0 + lane // 4 + (e // 2) * 8, n0 + 2 * (lane % 4) + e % 2


def _load_b_frags(mem, nt, row_addr):
    """load_b_frags: row_addr [32] (lane i: row i % 16 of the k-step, column
    n0) -> b [nt][32, 2, 2]."""
    half = (np.arange(32) // 16) * 8
    out = []
    for j in range(0, nt - 1, 2):
        r = _ldsm(mem, row_addr + 8 * j + half, 4, trans=True)
        out += [r[:, 0:2], r[:, 2:4]]
    if nt % 2:
        out.append(_ldsm(mem, row_addr + 8 * (nt - 1), 2, trans=True))
    return out


def _conv_tc(mem, in0, in_s, in_side, step, taps, ntap, k_ch, w0, n, out_side, mt, nt):
    """conv_tc's outputs {(p, co): value} (one warp's view of every item)."""
    np_ = pix_stride(n)
    npos = out_side * out_side
    ntiles = -(-n // 8)
    nng = -(-ntiles // nt)
    items = -(-npos // (16 * mt)) * nng
    lane = np.arange(32)
    lrow, lcol = lane % 16, 8 * (lane // 16)
    out = {}
    for it in range(items):
        mg, n_own = it // nng, it % nng * 8 * nt
        m0 = mg * 16 * mt
        n0 = min(n_own, (ntiles - nt) * 8)
        px = []
        for i in range(mt):
            p = np.where(m0 + 16 * i + lrow < npos, m0 + 16 * i + lrow, 0)
            px.append(p // out_side * step * in_side + p % out_side * step)
        acc = np.zeros((mt, nt, 32, 4))
        for tap in range(ntap):
            a_row = [in0 + (px[i] + taps(tap)) * in_s + lcol for i in range(mt)]
            w_tap = w0 + tap * k_ch * np_ + n0
            for k0 in range(0, k_ch, 16):
                a = [_ldsm(mem, a_row[i] + k0) for i in range(mt)]
                k = k0 + lrow
                b = _load_b_frags(mem, nt, np.where(k < k_ch, w_tap + k * np_, n0))
                for i in range(mt):
                    for j in range(nt):
                        _mma(acc[i, j], a[i], b[j])
        for i in range(mt):                          # the epilogue: each row's (r, c) once
            for h in range(2):
                p = m0 + 16 * i + lane // 4 + 8 * h
                for j in range(nt):
                    for e in range(2):
                        co = n0 + 8 * j + 2 * (lane % 4) + e
                        for lane_ in range(32):
                            if p[lane_] < npos and n_own <= co[lane_] < n:
                                key = (int(p[lane_]), int(co[lane_]))
                                assert key not in out
                                out[key] = acc[i, j, lane_, 2 * h + e]
    assert len(out) == npos * n
    return out


def _wgrad_tc(mem, a0, a_s, apix, m, b0, b_s, bpix, n, ntap, npx, nt):
    """wgrad_tc's sums {(tap, ci, co): value}."""
    nmt, ntiles = -(-m // 16), -(-n // 8)
    nng = -(-ntiles // nt)
    lane = np.arange(32)
    arow, acol, brow = lane % 8 + 8 * (lane // 16), 8 * (lane // 8 % 2), lane % 16
    out = {}
    for it in range(ntap * nmt * nng):
        n_own, rest = it % nng * 8 * nt, it // nng
        m0, tap = rest % nmt * 16, rest // nmt
        n0 = min(n_own, (ntiles - nt) * 8)
        acc = np.zeros((nt, 32, 4))
        for k0 in range(0, npx, 16):
            ka, kb = k0 + arow, k0 + brow
            rows_a = np.array([apix(tap, k) for k in np.minimum(ka, npx - 1)])
            a_addr = np.where(ka < npx, a0 + rows_a * a_s + m0 + acol, m0 + acol)
            a = _ldsm(mem, a_addr, trans=True)
            rows_b = np.array([bpix(tap, k) for k in np.minimum(kb, npx - 1)])
            b_addr = np.where(kb < npx, b0 + rows_b * b_s + n0, n0)
            b = _load_b_frags(mem, nt, b_addr)
            for j in range(nt):
                _mma(acc[j], a, b[j])
        for j in range(nt):
            for e in range(4):
                ms, ns = _entry(e, m0, n0 + 8 * j)
                for lane_, (mm, nn) in enumerate(zip(ms, ns)):
                    if mm < m and n_own <= nn < n:
                        assert (tap, mm, nn) not in out
                        out[(tap, mm, nn)] = acc[j, lane_, e]
    assert len(out) == ntap * m * n
    return out


class _Smem:
    """A flat bf16 shared memory: the zero region, then regions appended."""

    def __init__(self, zero):
        self.mem = [np.zeros(zero)]
        self.size = zero

    def plane(self, vals):
        """vals [npix, c] -> its pixel-major plane with a 16-byte tail; returns its offset."""
        npix, c = vals.shape
        pl = np.zeros((npix, pix_stride(c)))
        pl[:, :c] = vals
        return self._add(np.concatenate([pl.ravel(), np.zeros(8)]))

    def operand(self, w):
        """w [ntap, K, N] -> [ntap][K][pix_stride(N)]; returns its offset."""
        pad = np.zeros(w.shape[:2] + (pix_stride(w.shape[2]),))
        pad[..., :w.shape[2]] = w
        return self._add(pad.ravel())

    def _add(self, a):
        off = self.size
        self.mem.append(a)
        self.size += a.size
        return off

    def array(self):
        return np.concatenate(self.mem + [np.zeros(64)])


def _bf16_vals(rng, *shape):
    return _bf16(rng.normal(size=shape).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("k_ch,n,mt", [(21, 21, 2), (40, 56, 1), (16, 1, 1), (83, 83, 1)])
def test_rehearsal_conv_3x3_and_deconv_phase(k_ch, n, mt):
    """A 3x3 conv over an (s+2)^2 plane onto an s^2 box, and a one-tap conv
    (a deconv phase), against the plain convs; every output once."""
    rng = np.random.default_rng(k_ch + n)
    side = 6
    inp = _bf16_vals(rng, side + 2, side + 2, k_ch)
    w = _bf16_vals(rng, 9, k_ch, n)
    sm = _Smem(max(pix_stride(k_ch), pix_stride(n)) + 16)
    in0, w0 = sm.plane(inp.reshape(-1, k_ch)), sm.operand(w)
    mem = sm.array()
    nt = n_group(n)
    got = _conv_tc(mem, in0, pix_stride(k_ch), side + 2, 1, lambda t: t // 3 * (side + 2)
                      + t % 3, 9, k_ch, w0, n, side, mt, nt)
    want = sum(inp[ky:ky + side, kx:kx + side].reshape(-1, k_ch) @ w[ky * 3 + kx]
               for ky in range(3) for kx in range(3))
    for (p, co), v in got.items():
        assert abs(v - want[p, co]) <= 1e-9 * max(1.0, abs(want[p, co])), (p, co)
    one = _conv_tc(mem, in0, pix_stride(k_ch), side + 2, 1, lambda t: 0, 1, k_ch, w0, n,
                      side + 2, mt, nt)
    want1 = inp.reshape(-1, k_ch) @ w[0]
    assert all(abs(v - want1[p, co]) <= 1e-9 * max(1.0, abs(want1[p, co]))
               for (p, co), v in one.items())


def test_rehearsal_dx_reads_dh_phases_at_step_2():
    """dx: the four deconv phases of a T x T dh plane, read at step 2, as
    the taps of a one-pixel conv against wdT [4][Cd][Cin]."""
    rng = np.random.default_rng(5)
    t, cd, cin = 8, 21, 41
    dh = _bf16_vals(rng, t, t, cd)
    wdt = _bf16_vals(rng, 4, cd, cin)
    sm = _Smem(pix_stride(cin) + 16)
    in0, w0 = sm.plane(dh.reshape(-1, cd)), sm.operand(wdt)
    got = _conv_tc(sm.array(), in0, pix_stride(cd), t, 2, lambda ph: ph // 2 * t + ph % 2, 4,
                      cd, w0, cin, t // 2, 1, n_group(cin))
    want = sum(dh[di::2, dj::2].reshape(-1, cd) @ wdt[di * 2 + dj]
               for di in range(2) for dj in range(2))
    assert all(abs(v - want[p, co]) <= 1e-9 * max(1.0, abs(want[p, co]))
               for (p, co), v in got.items())


@pytest.mark.parametrize("t", [16, 8, 4])
def test_rehearsal_weight_gradients(t):
    """dw2 (g on the (t+2)^2 box shifted by each tap against dy at the
    centre of the (t+4)^2 box) and dwd (x on the coarse box against dh's
    phases; t = 4: 4 pixels, a ragged k-step), by B3's pixel maps."""
    rng = np.random.default_rng(t)
    c1, cout, cin, cd = 40, 6, 19, 10         # c1: 3 m-tiles, a ragged last m-group
    hs, gs, xs, tc = t + 4, t + 2, (t + 4) // 2, t // 2
    g = _bf16_vals(rng, gs, gs, c1)
    dy = _bf16_vals(rng, hs, hs, cout)
    x = _bf16_vals(rng, xs, xs, cin)
    dh = _bf16_vals(rng, t, t, cd)
    sm = _Smem(max(pix_stride(c) for c in (c1, cout, cin, cd)) + 16)
    g0, dy0 = sm.plane(g.reshape(-1, c1)), sm.plane(dy.reshape(-1, cout))
    x0, dh0 = sm.plane(x.reshape(-1, cin)), sm.plane(dh.reshape(-1, cd))
    mem = sm.array()
    dw2 = _wgrad_tc(mem, g0, pix_stride(c1), lambda tap, k: (k // t + tap // 3) * gs + k % t
                       + tap % 3, c1, dy0, pix_stride(cout), lambda _, k: (k // t + 2) * hs
                       + k % t + 2, cout, 9, t * t, n_group(cout))
    for (tap, ci, co), v in dw2.items():
        ky, kx = tap // 3, tap % 3
        want = (g[ky:ky + t, kx:kx + t, ci] * dy[2:2 + t, 2:2 + t, co]).sum()
        assert abs(v - want) <= 1e-9 * max(1.0, abs(want))
    dwd = _wgrad_tc(mem, x0, pix_stride(cin), lambda _, k: (k // tc + 1) * xs + k % tc + 1,
                       cin, dh0, pix_stride(cd), lambda ph, k: (2 * (k // tc) + ph // 2) * t
                       + 2 * (k % tc) + ph % 2, cd, 4, tc * tc, n_group(cd))
    for (ph, ci, co), v in dwd.items():
        want = (x[1:1 + tc, 1:1 + tc, ci] * dh[ph // 2::2, ph % 2::2, co]).sum()
        assert abs(v - want) <= 1e-9 * max(1.0, abs(want))


@pytest.mark.parametrize("m,n,k", [(81, 40, 64), (5, 3, 4), (41, 16, 21)])
def test_rehearsal_probe(m, n, k):
    """mma_probe_bf16_kernel's staging (a row by row at pix_stride(k), b as
    an operand) and items, against a @ b."""
    rng = np.random.default_rng(m)
    a, b = _bf16_vals(rng, m, k), _bf16_vals(rng, k, n)
    sm = _Smem(max(pix_stride(n), pix_stride(k)) + 16)
    a0, b0 = sm.plane(a), sm.operand(b[None])
    mem = sm.array()
    nt = n_group(n)
    ntiles = -(-n // 8)
    nng = -(-ntiles // nt)
    lane = np.arange(32)
    lrow, lcol = lane % 16, 8 * (lane // 16)
    as_, np_ = pix_stride(k), pix_stride(n)
    c = np.full((m, n), np.nan)
    for it in range(-(-m // 16) * nng):
        m0, n_own = it // nng * 16, it % nng * 8 * nt
        n0 = min(n_own, (ntiles - nt) * 8)
        row = np.where(m0 + lrow < m, m0 + lrow, 0)
        acc = np.zeros((nt, 32, 4))
        for k0 in range(0, k, 16):
            aa = _ldsm(mem, a0 + row * as_ + k0 + lcol)
            bb = _load_b_frags(mem, nt, np.where(k0 + lrow < k, b0 + (k0 + lrow) * np_ + n0, n0))
            for j in range(nt):
                _mma(acc[j], aa, bb[j])
        for j in range(nt):
            for e in range(4):
                ms, ns = _entry(e, m0, n0 + 8 * j)
                for lane_, (mm, nn) in enumerate(zip(ms, ns)):
                    if mm < m and n_own <= nn < n:
                        c[mm, nn] = acc[j, lane_, e]
    np.testing.assert_allclose(c, a @ b, rtol=1e-12, atol=1e-12)


def test_bf16_rows_must_be_16_byte_aligned():
    """The bf16 kernels copy the activations' pixel rows by cp.async: the
    wrappers refuse a tensor that does not start on a 16-byte boundary."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    lmu_cuda._check_bf16_rows((("x", x), ("skip", None)))
    with pytest.raises(ValueError, match="16-byte"):
        lmu_cuda._check_bf16_rows((("dy", x[1:]),))
