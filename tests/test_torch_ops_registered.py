"""B1's and B2's forwards as registered ops (ccvpe_tpu_torch::corr_fwd,
::lmu_fwd): torch.library.opcheck on each (schema, fake implementation,
the CPU implementation through the dispatcher), each op's CPU output
against the JAX package's Pallas kernel in CPU interpret mode (as
tests/test_corr_pallas.py and tests/test_lmu_pallas.py run them), and the
two ops as single nodes of an exported program.

Tolerances: B1 CORR_TOL (_torch_helpers.py), B2 atol/rtol 1e-5 (as
tests/test_torch_lmu.py: float32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_helpers import CORR_TOL, one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.ops.corr_pallas import rolled_corr_pallas
from ccvpe_tpu.ops.lmu_pallas import fused_stage as jax_fused_stage
from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
from ccvpe_tpu_torch.ops.corr import build_roll_matrices

LMU_TOL = dict(atol=1e-5, rtol=1e-5)


def corr_operands(b, n, d, k, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(b, n, d, generator=g).to(dtype)
    gm = torch.randn(b, k, d, generator=g)
    m = (torch.rand(k, d, generator=g) > 0.3).float()
    return s, gm, m


def lmu_operands(b, hc, wc, cin, cs, cd, c1, cout, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, generator=g) * 0.3

    x = mk(b, hc, wc, cin).to(dtype)
    skip = mk(b, 2 * hc, 2 * wc, cs).to(dtype) if cs else None
    return (x, skip, mk(cin, cd, 2, 2), mk(cd), mk(c1, cd + cs, 3, 3), mk(c1),
            mk(cout, c1, 3, 3), mk(cout))


OPCHECK_CASES = {
    "corr f32": (corr_cuda.corr_fwd, lambda: (*corr_operands(2, 70, 24, 5), False, False)),
    "corr f32 with r": (corr_cuda.corr_fwd, lambda: (*corr_operands(2, 70, 24, 5), True, False)),
    "corr bf16 S with r": (corr_cuda.corr_fwd,
                           lambda: (*corr_operands(1, 33, 16, 3, dtype=torch.bfloat16), True,
                                    False)),
    "corr bf16 S, S^2 rounded": (corr_cuda.corr_fwd,
                                 lambda: (*corr_operands(1, 33, 16, 3, dtype=torch.bfloat16),
                                          False, True)),
    "lmu f32 skip": (lmu_cuda.lmu_fwd, lambda: (*lmu_operands(2, 3, 4, 5, 3, 4, 6, 2), 0)),
    "lmu f32 no skip": (lmu_cuda.lmu_fwd, lambda: (*lmu_operands(1, 3, 5, 7, 0, 4, 5, 1), 0)),
    "lmu bf16 x": (lmu_cuda.lmu_fwd,
                   lambda: (*lmu_operands(2, 3, 4, 5, 3, 4, 6, 2, dtype=torch.bfloat16), 0)),
}


@pytest.mark.parametrize("case", list(OPCHECK_CASES))
def test_opcheck(case):
    op, args = OPCHECK_CASES[case]
    torch.library.opcheck(op, args())


# opcheck with gradients wanted: the registered backward through the
# dispatcher and under fake tensors (B1 needs need_r for its backward)
GRAD_OPCHECK_CASES = {
    "corr f32 with r": (corr_cuda.corr_fwd, lambda: (*corr_operands(2, 70, 24, 5), True, False),
                        (0, 1)),
    "lmu f32 skip": (lmu_cuda.lmu_fwd, lambda: (*lmu_operands(2, 3, 4, 5, 3, 4, 6, 2), 0),
                     range(8)),
    "lmu f32 no skip": (lmu_cuda.lmu_fwd, lambda: (*lmu_operands(1, 3, 5, 7, 0, 4, 5, 1), 0),
                        (0, *range(2, 8))),
}


@pytest.mark.parametrize("case", list(GRAD_OPCHECK_CASES))
def test_opcheck_with_grad(case):
    op, args, leaves = GRAD_OPCHECK_CASES[case]
    args = list(args())
    for i in leaves:
        args[i] = args[i].requires_grad_()
    torch.library.opcheck(op, tuple(args))


def test_corr_op_outputs_and_counts():
    """corr_core gives the op's out (and r with need_r); an empty r
    without; CPU tensors launch nothing."""
    s, g, m = corr_operands(2, 70, 24, 5)
    before = corr_cuda.corr_core.launches
    out, r = torch.ops.ccvpe_tpu_torch.corr_fwd(s, g, m, False, False)
    assert r.shape == (0,) and out.shape == (2, 70, 5)
    out_r, r = torch.ops.ccvpe_tpu_torch.corr_fwd(s, g, m, True, False)
    want, want_r = corr_cuda.corr_core_plain(s, g, m, need_r=True)
    assert torch.equal(out, want) and torch.equal(out_r, want) and torch.equal(r, want_r)
    assert torch.equal(corr_cuda.corr_core(s, g, m), want)
    assert corr_cuda.corr_core.launches == before


# (b, h, w, D, L, shift, K, center, bins): cases of tests/test_torch_corr.py
CORR_CASES = [(2, 8, 8, 1280, 1280, 64, 20, False, None),
              (2, 8, 8, 1280, 224, 64, 20, True, None),
              (2, 16, 16, 40, 40, 2, 20, False, None),
              (2, 8, 8, 320, 320, 16, 20, False, tuple(range(-2, 3)))]


@pytest.mark.parametrize("case", CORR_CASES, ids=[f"D{c[3]}_L{c[4]}{'_center' if c[7] else ''}"
                                                  f"{'_bins' if c[8] else ''}" for c in CORR_CASES])
def test_corr_op_matches_pallas(case):
    b, h, w, d, length, shift, k, center, bins = case
    rng = np.random.default_rng(7)
    sat = rng.normal(size=(b, h, w, d)).astype(np.float32)
    grd = rng.normal(size=(b, length)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(rolled_corr_pallas(jnp.asarray(sat), jnp.asarray(grd), shift, k,
                                            center, bins))
    bins = tuple(range(k)) if bins is None else bins
    g_t = torch.from_numpy(grd)
    g_mat, m_mat = build_roll_matrices(g_t, d, shift, bins, center)
    g_mat = (g_mat / torch.linalg.vector_norm(g_t, dim=-1)[:, None, None]).contiguous()
    out, _ = torch.ops.ccvpe_tpu_torch.corr_fwd(
        torch.from_numpy(sat).reshape(b, h * w, d), g_mat, m_mat.contiguous(), False, False)
    np.testing.assert_allclose(out.reshape(b, h, w, len(bins)).numpy(), ref, **CORR_TOL)


# (b, hc, wc, cin, cd, cskip, c1, cout, strip): tests/test_torch_lmu.py's
LMU_CASES = [(2, 8, 16, 7, 5, 3, 6, 2, 4), (2, 8, 16, 7, 5, 0, 6, 2, 4),
             (1, 8, 32, 41, 16, 0, 16, 1, 4)]


@pytest.mark.parametrize("case", LMU_CASES, ids=[f"skip{c[5]}_cin{c[3]}" for c in LMU_CASES])
def test_lmu_op_matches_pallas(case):
    b, hc, wc, cin, cd, cs, c1, cout, strip = case
    rng = np.random.default_rng(3)

    def mk(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = mk(b, hc, wc, cin)
    skip = mk(b, 2 * hc, 2 * wc, cs) if cs else None
    ws = (mk(2, 2, cin, cd), mk(cd), mk(3, 3, cd + cs, c1), mk(c1), mk(3, 3, c1, cout),
          mk(cout))
    ref = np.asarray(jax_fused_stage(jnp.asarray(x), None if skip is None else jnp.asarray(skip),
                                     *map(jnp.asarray, ws), strip=strip, interpret=True))
    wd, bd, w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(w)) for w in ws)
    out = torch.ops.ccvpe_tpu_torch.lmu_fwd(
        torch.from_numpy(x), None if skip is None else torch.from_numpy(skip),
        wd.permute(2, 3, 0, 1), bd, w1.permute(3, 2, 0, 1), b1, w2.permute(3, 2, 0, 1), b2, 0)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **LMU_TOL)


def test_ops_carry_their_registered_backward():
    """One path with and without gradients: no autograd node where none is
    wanted, the op's registered backward where one is, the same values."""
    args = lmu_operands(2, 3, 4, 5, 3, 4, 6, 2)
    y = lmu_cuda.fused_stage(*args)
    assert y.grad_fn is None
    params = [t.clone().requires_grad_() for t in args[2:]]
    y_grad = lmu_cuda.fused_stage(*args[:2], *params)
    assert "lmu_fwd" in type(y_grad.grad_fn).__name__
    assert torch.equal(y, y_grad.detach())
    s, g, m = corr_operands(2, 70, 24, 5)
    out = corr_cuda.corr_core_diff(s, g, m)
    assert out.grad_fn is None
    out_grad = corr_cuda.corr_core_diff(s.requires_grad_(), g, m)
    assert "corr_fwd" in type(out_grad.grad_fn).__name__
    assert torch.equal(out, out_grad.detach())


class _Both(torch.nn.Module):
    def forward(self, s, g, m, x, skip, wd, bd, w1, b1, w2, b2):
        out, _ = torch.ops.ccvpe_tpu_torch.corr_fwd(s, g, m, False, False)
        return out, lmu_cuda.fused_stage(x, skip, wd, bd, w1, b1, w2, b2)


def test_ops_are_single_nodes_of_an_exported_program():
    args = (*corr_operands(1, 16, 8, 3), *lmu_operands(1, 2, 3, 4, 2, 3, 4, 1))
    ep = torch.export.export(_Both(), args)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("ccvpe_tpu_torch.corr_fwd.default") == 1
    assert targets.count("ccvpe_tpu_torch.lmu_fwd.default") == 1
    got = ep.module()(*args)
    want = _Both()(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
