"""Port vs JAX: the fused LMU stage on bf16 activations
(ModelConfig.compute_dtype='bfloat16' with lmu_fused_min_res). The JAX
side is the Pallas forward and backward kernels on bf16 inputs in CPU
interpret mode (as tests/test_lmu_pallas.py runs them); the port side is
the plain versions of ops/lmu.py under the bf16 policy, which the wrappers
of ops/lmu_cuda.py run on CPU tensors, and the split emulations of the
kernels' arithmetic (the card's oracle). The CUDA kernels themselves are
held against the split emulations on the card by chip_smoke.py.

Tolerances: both packages round h, conv_a, da, dh, dx and dskip to bf16
after float32 sums taken in another order, so a value within roundoff of
a rounding tie lands one bf16 ulp apart, and that moves what follows; every
output is held within ULPS bf16 ulps of its own largest magnitude (one
ulp: 2^-7 relative at the top binade's start), as tests/test_torch_bf16.py
holds its modules. The whole tiny() model under the rules of
tests/test_torch_bf16.py."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccvpe_tpu.ops.corr as jcorr
from _helpers import raw_ori_norm
from _torch_helpers import CORR_TOL, HEATMAP_ATOL, OUT_TOL, jax_variables
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.nn import efficientnet as jeff
from ccvpe_tpu.ops.lmu_pallas import fused_stage, fused_stage_bwd_pallas
from ccvpe_tpu.train import step as jstep
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.nn import efficientnet as teff
from ccvpe_tpu_torch.ops import lmu_cuda
from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain, round_bf16
from ccvpe_tpu_torch.ops.lmu_cuda import (fused_stage_bf16_split_plain,
                                          fused_stage_bwd_bf16_split_plain, kernel_weights,
                                          kernel_weights_bf16)
from ccvpe_tpu_torch.train import step as tstep
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_bf16 import BENCH, GRAD_ATOL, _tpu_dispatch_rolled_corr, _train_batch, ulp_scale
from test_torch_lmu import NAMES, _case, _j, _t, _to_jax_layout, _torch_weights

ULPS = 4


def _bf16(a):
    """numpy float32 -> bf16 values kept as float32 numpy (None passes)."""
    return None if a is None else np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t16(a):
    return None if a is None else torch.from_numpy(a).bfloat16()


def _j16(a):
    return None if a is None else jnp.asarray(a, jnp.bfloat16)


def assert_ulps(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= ULPS * ulp_scale(want), (name, err, ULPS * ulp_scale(want))


# (b, hc, wc, cin, cd, cskip, c1, cout, strip): tests/test_lmu_pallas.py's
# cases (skip 3 and none, strips 4 and 8) and the head-stage geometry
CASES = [(2, 8, 16, 7, 5, 3, 6, 2, 4), (2, 8, 16, 7, 5, 0, 6, 2, 4),
         (2, 8, 16, 7, 5, 3, 6, 2, 8), (2, 8, 16, 7, 5, 0, 6, 2, 8),
         (1, 8, 32, 41, 16, 0, 16, 1, 4)]
IDS = [f"skip{c[5]}_strip{c[8]}_cin{c[3]}" for c in CASES]


def _inputs(case, seed):
    *shape, strip = case
    x, skip, ws = _case(seed, *shape)
    return _bf16(x), _bf16(skip), ws, strip


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_forward_matches_pallas(case):
    x, skip, ws, strip = _inputs(case, 0)
    want = fused_stage(_j16(x), _j16(skip), *[jnp.asarray(w) for w in ws], strip=strip,
                       interpret=True)
    assert want.dtype == jnp.float32
    out = fused_stage_plain(_t16(x), _t16(skip), *_torch_weights(ws))
    assert out.dtype == torch.float32
    assert_ulps(out.numpy(), np.asarray(want), "y")
    # the kernel's arithmetic (the card's oracle) agrees too
    split = fused_stage_bf16_split_plain(_t16(x), _t16(skip), *_torch_weights(ws))
    assert_ulps(split.numpy(), out.numpy(), "split y")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_backward_matches_pallas(case):
    x, skip, ws, strip = _inputs(case, 7)
    b, hc, wc, *_, cout, _ = case
    dy = (np.random.default_rng(8).normal(size=(b, 2 * hc, 2 * wc, cout)) * 0.3).astype(np.float32)
    want = fused_stage_bwd_pallas(_j16(x), _j16(skip), jnp.asarray(dy),
                                  *[jnp.asarray(w) for w in ws], strip=strip, interpret=True)
    grads = fused_stage_bwd_plain(_t16(x), _t16(skip), torch.from_numpy(dy), *_torch_weights(ws))
    assert grads[0].dtype == torch.bfloat16 and want[0].dtype == jnp.bfloat16
    assert all(g.dtype == torch.float32 for g in grads[2:])
    got = _to_jax_layout([None if g is None else g.float() for g in grads])
    split = _to_jax_layout([None if g is None else g.float()
                            for g in fused_stage_bwd_bf16_split_plain(
                                _t16(x), _t16(skip), torch.from_numpy(dy), *_torch_weights(ws))])
    for name, g, s, w in zip(NAMES, got, split, want):
        if w is None:
            assert g is None and s is None and not case[5]
            continue
        assert_ulps(g, np.asarray(w.astype(jnp.float32)), name)
        assert_ulps(s, g, "split " + name)


def test_bf16_rounds_where_the_tpu_kernel_rounds():
    """Every rounding point matters: with inputs whose float32 chain is far
    from bf16 (the h and g sums), the bf16 plain version is closer to the
    Pallas bf16 kernel than to the float32 chain on the same bf16 inputs."""
    x, skip, ws, strip = _inputs(CASES[0], 3)
    want = np.asarray(fused_stage(_j16(x), _j16(skip), *[jnp.asarray(w) for w in ws],
                                  strip=strip, interpret=True))
    bf16 = fused_stage_plain(_t16(x), _t16(skip), *_torch_weights(ws)).numpy()
    f32 = fused_stage_plain(_t(x), _t(skip), *_torch_weights(ws)).numpy()
    assert np.abs(bf16 - want).max() < np.abs(f32 - want).max() / 4


def test_wrappers_on_cpu_take_the_bf16_plain_versions():
    """fused_stage and fused_stage_bwd on CPU bf16 tensors: the plain bf16
    policy, dx and dskip in bf16, no launch counted."""
    x, skip, ws, _ = _inputs(CASES[0], 4)
    tw = _torch_weights(ws)
    before = (lmu_cuda.fused_stage.launches, lmu_cuda.fused_stage.bf16_launches,
              lmu_cuda.fused_stage_bwd.launches, lmu_cuda.fused_stage_bwd.bf16_launches)
    y = lmu_cuda.fused_stage(_t16(x), _t16(skip), *tw)
    assert torch.equal(y, fused_stage_plain(_t16(x), _t16(skip), *tw))
    dy = torch.randn(*y.shape, generator=torch.Generator().manual_seed(0))
    got = lmu_cuda.fused_stage_bwd(_t16(x), _t16(skip), dy, *tw)
    want = fused_stage_bwd_plain(_t16(x), _t16(skip), dy, *tw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert before == (lmu_cuda.fused_stage.launches, lmu_cuda.fused_stage.bf16_launches,
                      lmu_cuda.fused_stage_bwd.launches, lmu_cuda.fused_stage_bwd.bf16_launches)


def test_fused_stage_function_in_bf16():
    """lmu_cuda.fused_stage on bf16 CPU activations: float32 y; the backward's
    dx and dskip in bf16 (the inputs' type), the weights' in float32, as
    fused_stage_bwd_plain gives them."""
    x, skip, ws, _ = _inputs(CASES[0], 5)
    xs = _t16(x).requires_grad_()
    ss = _t16(skip).requires_grad_()
    params = [w.clone().requires_grad_() for w in _torch_weights(ws)]
    y = lmu_cuda.fused_stage(xs, ss, *params)
    assert y.dtype == torch.float32
    dy = torch.randn(*y.shape, generator=torch.Generator().manual_seed(1))
    y.backward(dy)
    want = fused_stage_bwd_plain(_t16(x), _t16(skip), dy, *_torch_weights(ws))
    assert xs.grad.dtype == ss.grad.dtype == torch.bfloat16
    for leaf, w, name in zip([xs, ss] + params, want, NAMES):
        assert torch.equal(leaf.grad, w), name


def test_kernel_weights_round_to_bf16():
    """The bf16 kernels' weight operands are bf16 arrays of the weights
    rounded to bf16 (the TPU kernel casts them to x.dtype, :381-383): the
    float32 kernels' operands of the rounded weights, each row padded with
    zeros to pix_stride columns (csrc/lmu_bf16.cu) instead of pad_co."""
    _, _, ws = _case(9, 1, 2, 2, 5, 4, 3, 6, 2)
    tw = _torch_weights(ws)
    for a, b in zip(kernel_weights_bf16(*tw[0::2]),
                    kernel_weights(*(round_bf16(w) for w in tw[0::2]))):
        n = b.shape[-1]
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        assert a.shape[:-1] == b.shape[:-1] and a.shape[-1] == lmu_cuda.pix_stride(a.shape[-1])
        assert torch.equal(a[..., :n].float(), b[..., :n])
        assert not a[..., n:].float().any()


def test_other_activation_types_raise():
    x = torch.zeros(1, 2, 2, 5, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        lmu_cuda._act_dtype(x)


# --- the whole tiny() model, fused stages in bf16 ---

FUSED = dict(compute_dtype="bfloat16", lmu_fused_min_res=32)


@pytest.mark.slow
def test_bf16_fused_forward_within_twice_jax_own():
    """tiny() with bf16 fused stages (three a decoder): the port's outputs
    at most twice JAX's own bf16-vs-float32 error from JAX's bf16 fused
    forward (Pallas in interpret mode), plus the float32 floor, as
    tests/test_torch_bf16.py holds the unfused bf16 forward."""
    cfg = jcfg.tiny()
    rng = np.random.default_rng(21)
    grd = rng.normal(size=(2, *cfg.grd_size, 3)).astype(np.float32)
    sat = rng.normal(size=(2, *cfg.sat_size, 3)).astype(np.float32)
    variables = jax_variables(JaxCVM(cfg), grd[:1], sat[:1], False, seed=22)
    f32 = jax.tree.map(np.asarray, jax.jit(lambda v, g, s: JaxCVM(cfg).apply(v, g, s, False))(
        variables, grd, sat))
    model = JaxCVM(dataclasses.replace(cfg, **FUSED))
    with mock.patch.object(jcorr, "rolled_corr", _tpu_dispatch_rolled_corr(jcorr.rolled_corr)):
        ref = jax.tree.map(np.asarray, jax.jit(lambda v, g, s: model.apply(v, g, s, False))(
            variables, grd, sat))
    norm = raw_ori_norm(JaxCVM(cfg), variables, grd, sat)
    well = np.broadcast_to(norm > 1e-2, f32.ori.shape)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        out = build_cvm(dataclasses.replace(tcfg.tiny(), **FUSED), "cpu", state_dict=sd)(
            torch.from_numpy(grd), torch.from_numpy(sat))
    pairs = [("logits", out.logits.numpy(), ref.logits, f32.logits, OUT_TOL["atol"]),
             ("heatmap", out.heatmap.numpy(), ref.heatmap, f32.heatmap, HEATMAP_ATOL),
             ("ori", out.ori.numpy()[well], ref.ori[well], f32.ori[well], OUT_TOL["atol"])]
    pairs += [(f"scores {i + 1}", a.numpy(), b, c, CORR_TOL["atol"]) for i, (a, b, c) in
              enumerate(zip(out.matching_scores, ref.matching_scores, f32.matching_scores))]
    for name, got, want, exact, floor in pairs:
        port_err = float(np.abs(got - want).max())
        own_err = float(np.abs(want - exact).max())
        assert port_err <= 2 * own_err + floor, (name, port_err, own_err)


@pytest.mark.slow
def test_bf16_fused_gradients_match_jax():
    """One loss backward with bf16 fused stages, drop-connect off, against
    the JAX package's loss_fn (its Pallas backward in interpret mode), at
    tests/test_torch_bf16.py::test_bf16_train_gradients_match_jax's
    configuration (bench.py's options at tiny(sat=256)) with
    lmu_fused_min_res=32: the fused stages take the four finest stages of
    each decoder, the ori decoder's last two windowed (80 and 160 px).

    That test's whole-model clauses hold: the port's error to JAX's bf16
    gradient at most twice JAX's own bf16-vs-float32 error, and the port's
    bf16 gradient at least half that far from its own float32 one. Its
    per-tensor clause does not fit here: the ori head's gradients carry
    bf16 noise that l2_normalize amplifies, one draw a seed (conv1_ori.0's
    relative error to float32 read 0.41 in the port against JAX's 0.21 at
    this seed, 0.24 against JAX's 0.71 at another, and the unfused bf16
    model misses that clause at tiny() too). In its place every fused
    backward call of the port's step is held to the Pallas backward on that
    call's own inputs, within ULPS bf16 ulps of each output's scale."""
    dtypes = ("bfloat16", "float32")
    over = dict(BENCH, remat_policy="save_dw", remat_decoder=True, lmu_fused_min_res=32)
    jcfgs = {d: dataclasses.replace(jcfg.tiny(sat=256), **dict(over, compute_dtype=d))
             for d in dtypes}
    batch = _train_batch(jcfgs["float32"])
    variables = jax_variables(JaxCVM(jcfgs["float32"]),
                              np.zeros((1, *batch.grd.shape[1:]), np.float32),
                              np.zeros((1, *batch.sat.shape[1:]), np.float32), False, seed=23)
    want = {}
    with mock.patch.object(jeff, "DROP_CONNECT_RATE", 0.0), \
            mock.patch.object(jcorr, "rolled_corr", _tpu_dispatch_rolled_corr(jcorr.rolled_corr)):
        for d, cfg in jcfgs.items():
            loss_fn = jstep.make_loss_fn(JaxCVM(cfg), cfg, jcfg.TrainConfig())
            grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(
                variables["params"], variables["batch_stats"],
                jstep.Batch(*map(jnp.asarray, batch)), jax.random.PRNGKey(0))
            want[d] = state_dict_from_jax(jax.tree.map(np.asarray, grads),
                                          variables["batch_stats"])
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    got, calls = {}, []

    def recorded(*args):
        calls.append(tuple(None if t is None else t.detach() for t in args))
        return fused_stage_bwd_plain(*args)

    for d in dtypes:
        cfg = dataclasses.replace(tcfg.tiny(sat=256), **dict(over, compute_dtype=d))
        with mock.patch.object(teff, "DROP_CONNECT_RATE", 0.0), \
                mock.patch.object(lmu_cuda, "fused_stage_bwd", recorded):
            state = tstep.create_train_state(cfg, tcfg.TrainConfig(), device="cpu",
                                             state_dict=sd)
            state, _ = tstep.make_train_step(cfg, tcfg.TrainConfig())(
                state, tstep.Batch(*map(torch.from_numpy, batch)))
        got[d] = {n: p.grad.numpy().astype(np.float64) for n, p in
                  state.model.named_parameters()}
    names = sorted(got["bfloat16"])
    p16, p32 = got["bfloat16"], got["float32"]
    j16, j32 = ({n: want[d][n].numpy().astype(np.float64) for n in names} for d in dtypes)

    def total(a, b):
        return np.sqrt(sum(np.linalg.norm(a[n] - b[n]) ** 2 for n in names))

    own = total(j16, j32)
    assert total(p16, j16) <= 2 * own, (total(p16, j16), own)
    assert total(p16, p32) >= own / 2, (total(p16, p32), own)
    # four stages of each decoder in bf16, then the same in float32
    assert [c[0].dtype for c in calls] == [torch.bfloat16] * 8 + [torch.float32] * 8
    for x, skip, dy, *ws in calls[:8]:
        jws = [jnp.asarray(w.detach().numpy()) for w in (
            ws[0].permute(2, 3, 0, 1), ws[1], ws[2].permute(2, 3, 1, 0), ws[3],
            ws[4].permute(2, 3, 1, 0), ws[5])]
        ref = fused_stage_bwd_pallas(_j16(x.float().numpy()),
                                     None if skip is None else _j16(skip.float().numpy()),
                                     jnp.asarray(dy.float().numpy()), *jws, strip=8,
                                     interpret=True)
        mine = _to_jax_layout([None if g is None else g.float()
                               for g in fused_stage_bwd_plain(x, skip, dy, *ws)])
        for name, g, w in zip(NAMES, mine, ref):
            if w is not None:
                assert_ulps(g, np.asarray(w.astype(jnp.float32)), (tuple(x.shape), name))
