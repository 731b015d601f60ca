"""Port vs JAX: the rolled correlation. The JAX side is the Pallas kernel
run in CPU interpret mode (as tests/test_corr_pallas.py runs it); the port
side is the plain `rolled_corr`, `corr_core_plain` (through
`rolled_corr_cuda`, which takes it for a CPU tensor), the loop
transcription `rolled_corr_reference` and `corr_core_split_plain`, the
kernel's per-slice 3xTF32 arithmetic."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_helpers import CORR_TOL
from ccvpe_tpu.ops.corr_pallas import rolled_corr_pallas
from ccvpe_tpu_torch.ops import corr as tcorr
from ccvpe_tpu_torch.ops.corr_cuda import (corr_core, corr_core_plain, corr_core_split_plain,
                                           corr_plan, rolled_corr_cuda)

# (b, h, w, D, L, shift, K, center, bins): the eight CASES of
# tests/test_corr_pallas.py, a restricted ori-prior case with negative bins
# and KITTI's level-6 shift of 8.
CASES = [
    (2, 8, 8, 1280, 1280, 64, 20, False, None),
    (1, 16, 16, 640, 640, 32, 20, False, None),
    (1, 8, 8, 2048, 512, 128, 16, False, None),
    (2, 8, 8, 1280, 224, 64, 20, True, None),
    (2, 16, 16, 40, 40, 2, 20, False, None),
    (1, 16, 16, 80, 80, 4, 20, False, None),
    (1, 8, 8, 64, 32, 8, 16, False, None),
    (1, 8, 8, 40, 20, 2, 20, True, None),
    (2, 8, 8, 320, 320, 16, 20, False, tuple(range(-2, 3))),
    (1, 16, 16, 32, 32, 8, 16, False, None),
]
IDS = [f"D{c[3]}_L{c[4]}_s{c[5]}_K{c[6]}{'_center' if c[7] else ''}"
       f"{'_bins' if c[8] else ''}" for c in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    b, h, w, d, length, shift, k, center, bins = request.param
    rng = np.random.default_rng(request.param_index)
    sat = rng.normal(size=(b, h, w, d)).astype(np.float32)
    grd = rng.normal(size=(b, length)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(rolled_corr_pallas(jnp.asarray(sat), jnp.asarray(grd),
                                            shift, k, center, bins))
    return sat, grd, shift, k, center, bins, ref


def test_plain_matches_pallas(case):
    sat, grd, shift, k, center, bins, ref = case
    out = tcorr.rolled_corr(torch.from_numpy(sat), torch.from_numpy(grd),
                            shift, k, center, bins)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **CORR_TOL)


def test_corr_core_plain_matches_pallas(case):
    sat, grd, shift, k, center, bins, ref = case
    before = corr_core.launches
    out = rolled_corr_cuda(torch.from_numpy(sat), torch.from_numpy(grd),
                           shift, k, center, bins)
    assert corr_core.launches == before      # CPU tensors launch no kernel
    np.testing.assert_allclose(out.numpy(), ref, **CORR_TOL)


def test_reference_loop_agrees(case):
    sat, grd, shift, k, center, bins, ref = case
    loop = tcorr.rolled_corr_reference(torch.from_numpy(sat), torch.from_numpy(grd),
                                       shift, k, center, bins)
    np.testing.assert_allclose(loop.numpy(), ref, **CORR_TOL)
    for impl in ("auto", "plain"):
        out = tcorr.rolled_corr_dispatch(torch.from_numpy(sat), torch.from_numpy(grd),
                                         shift, k, center, bins, impl)
        np.testing.assert_allclose(out.numpy(), loop.numpy(), **CORR_TOL)


def test_need_r_is_rsqrt_of_den2(rng):
    b, n, d, k = 2, 48, 96, 20
    s = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    grd = torch.from_numpy(rng.normal(size=(b, 64)).astype(np.float32))
    g_mat, m_mat = tcorr.build_roll_matrices(grd, d, 4, tuple(range(k)), center=True)
    out, r = corr_core(s, g_mat, m_mat, need_r=True)
    den2 = np.einsum("bnd,kd->bnk", s.numpy().astype(np.float64) ** 2,
                     m_mat.numpy().astype(np.float64))
    np.testing.assert_allclose(r.numpy(), 1.0 / np.sqrt(den2), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), corr_core_plain(s, g_mat, m_mat).numpy())
    assert out.shape == r.shape == (b, n, k)


# --- the kernel's arithmetic (corr_core_split_plain: per-slice 3xTF32 sums) ---
#
# CORR_TOL holds for it: each TF32 product of split parts is exact in
# float32, and the dropped lo.lo' terms are ~2^-22 of |S G'| (S^2's lo.M
# term is kept, M being exact), so num and den2 are float32-accurate sums
# in another order, as the plain version's are.


def split_inputs(sat, grd, shift, k, center, bins):
    """(S [B, h*w, D], G' [B, K, D], M [K, D]) as rolled_corr_cuda builds them."""
    bins = tuple(range(k)) if bins is None else bins
    sat, grd = torch.from_numpy(sat), torch.from_numpy(grd)
    b, h, w, d = sat.shape
    g_mat, m_mat = tcorr.build_roll_matrices(grd, d, shift, bins, center)
    g_mat = g_mat / torch.linalg.vector_norm(grd, dim=-1)[:, None, None]
    return sat.reshape(b, h * w, d), g_mat, m_mat


def check_split(sat, grd, shift, k, center, bins, ref):
    s, g_mat, m_mat = split_inputs(sat, grd, shift, k, center, bins)
    plan = corr_plan(s.shape[0], s.shape[1], s.shape[2], g_mat.shape[1])
    out, r = corr_core_split_plain(s, g_mat, m_mat, plan, need_r=True)
    want, want_r = corr_core_plain(s, g_mat, m_mat, need_r=True)
    np.testing.assert_allclose(out.reshape(ref.shape).numpy(), ref, **CORR_TOL)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **CORR_TOL)
    np.testing.assert_allclose(r.numpy(), want_r.numpy(), rtol=CORR_TOL["rtol"])
    return plan


def test_split_plain_matches_plain_and_pallas(case):
    sat, grd, shift, k, center, bins, ref = case
    check_split(sat, grd, shift, k, center, bins, ref)


@pytest.fixture(scope="module")
def ragged_case():
    """N = 1000 (not a multiple of the 64-row tile), D = 70 (not a multiple
    of 4 or 8), K = 32, centre window: the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(70)
    sat = rng.normal(size=(1, 25, 40, 70)).astype(np.float32)
    grd = rng.normal(size=(1, 50)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(rolled_corr_pallas(jnp.asarray(sat), jnp.asarray(grd), 3, 32, True))
    return sat, grd, 3, 32, True, None, ref


def test_split_plain_matches_pallas_ragged(ragged_case):
    plan = check_split(*ragged_case)
    assert plan.slices > 1 and 70 % plan.width != 0     # a ragged last slice


def test_split_plain_single_slice_is_one_partial_sum():
    """With one slice the emulation is the three + two products alone; with
    several it adds the slices' partial sums in slice order."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.normal(size=(1, 64, 48)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, 8, 48)).astype(np.float32))
    m = torch.from_numpy((rng.random((8, 48)) < 0.5).astype(np.float32))
    one = corr_plan(64, 64 * 64, 48, 8)
    assert one.slices == 1
    sliced = dataclasses.replace(one, slices=6, width=8)
    a = corr_core_split_plain(s, g, m, one)
    b = corr_core_split_plain(s, g, m, sliced)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **CORR_TOL)
    np.testing.assert_allclose(a.numpy(), corr_core_plain(s, g, m).numpy(), **CORR_TOL)


def test_window_offset_float_expression():
    # int(D/2 - L/2) with float division, as the reference writes it
    assert tcorr._window_offset(1280, 224, True) == 528
    assert tcorr._window_offset(41, 20, True) == 10
    assert tcorr._window_offset(1280, 224, False) == 0


def test_dispatch_rejects_bad_impl_and_cuda_on_cpu():
    sat, grd = torch.zeros(1, 2, 2, 8), torch.ones(1, 8)
    with pytest.raises(ValueError, match="corr_impl"):
        tcorr.rolled_corr_dispatch(sat, grd, 1, 4, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tcorr.rolled_corr_dispatch(sat, grd, 1, 4, impl="cuda")


# --- the backward (CorrCore, the counterpart of the custom VJP) ---

def test_corr_core_bwd_matches_jax_bwd(rng):
    """corr_core_bwd against JAX's _corr_core_bwd (plain jnp) on the same
    residuals (S, G', M, out, r) and cotangent."""
    from ccvpe_tpu.ops.corr_pallas import _corr_core_bwd
    from ccvpe_tpu_torch.ops.corr_cuda import corr_core_bwd

    b, n, d, k = 2, 40, 96, 20
    s = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    grd = torch.from_numpy(rng.normal(size=(b, 64)).astype(np.float32))
    g_mat, m_mat = tcorr.build_roll_matrices(grd, d, 4, tuple(range(k)), center=True)
    g_mat = g_mat / torch.linalg.vector_norm(grd, dim=-1)[:, None, None]
    out, r = corr_core_plain(s, g_mat, m_mat, need_r=True)
    gbar = torch.from_numpy(rng.normal(size=(b, n, k)).astype(np.float32))
    res = tuple(jnp.asarray(t.numpy()) for t in (s, g_mat, m_mat, out, r))
    want_s, want_g, want_m = _corr_core_bwd(res, jnp.asarray(gbar.numpy()))
    got_s, got_g = corr_core_bwd(gbar, s, g_mat, m_mat, out, r)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5, rtol=1e-4)
    assert not np.asarray(want_m).any()    # M gets no gradient on either side


# (b, h, w, D, L, shift, K, center, bins): VIGOR-like, centre window, prior
GRAD_CASES = [(2, 4, 4, 80, 80, 4, 20, False, None),
              (1, 4, 4, 64, 32, 8, 16, True, None),
              (2, 4, 4, 40, 40, 2, 20, False, tuple(range(-2, 3)))]


@pytest.mark.parametrize("impl", ["function", "dispatch_auto"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=["vigor", "center", "prior"])
def test_corr_grads_match_jax(case, impl):
    """Gradients of sat and grd through the port (rolled_corr_cuda, i.e.
    CorrCore, which a CUDA tensor takes; and rolled_corr_dispatch 'auto',
    the plain einsums on a CPU tensor) against jax.grad of the JAX
    package's ops/corr.py rolled_corr, for the loss sum(scores * weight)."""
    import jax
    from ccvpe_tpu.ops.corr import rolled_corr as jax_rolled_corr

    b, h, w, d, length, shift, k, center, bins = case
    rng = np.random.default_rng(23)
    sat = rng.normal(size=(b, h, w, d)).astype(np.float32)
    grd = rng.normal(size=(b, length)).astype(np.float32)
    kk = k if bins is None else len(bins)
    wgt = rng.normal(size=(b, h, w, kk)).astype(np.float32)

    def loss(s, g):
        return jnp.sum(jax_rolled_corr(s, g, shift, k, center, bins) * wgt)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(sat), jnp.asarray(grd))
    ts = torch.from_numpy(sat).requires_grad_()
    tg = torch.from_numpy(grd).requires_grad_()
    before = corr_core.launches
    if impl == "function":
        out = rolled_corr_cuda(ts, tg, shift, k, center, bins)
    else:
        out = tcorr.rolled_corr_dispatch(ts, tg, shift, k, center, bins, "auto")
    (out * torch.from_numpy(wgt)).sum().backward()
    assert corr_core.launches == before
    for got, ref in ((ts.grad, want[0]), (tg.grad, want[1])):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=1e-5)


def test_forward_without_grad_keeps_one_product():
    """With no gradient wanted, rolled_corr_cuda calls corr_core without r
    (the serving path); with one, it goes through CorrCore."""
    from unittest import mock

    from ccvpe_tpu_torch.ops import corr_cuda

    sat, grd = torch.randn(1, 2, 2, 16), torch.randn(1, 16)
    with mock.patch.object(corr_cuda, "corr_core", wraps=corr_cuda.corr_core) as spy:
        with torch.no_grad():
            corr_cuda.rolled_corr_cuda(sat, grd, 2, 4)
        corr_cuda.rolled_corr_cuda(sat.requires_grad_(), grd, 2, 4).sum().backward()
    assert [c.kwargs.get("need_r", False) for c in spy.call_args_list] == [False, True]
