"""Port vs JAX under ModelConfig.compute_dtype='bfloat16' (with
deconv_impl and corr_bf16), on the CPU.

bf16 rounds at other places in the two frameworks (a conv's bias added
before or after the output's rounding, excess precision inside XLA's
fusions), so the comparisons are in bf16 ulps, not bits:
- per module (one MBConv in eval and train mode, one decoder stage under
  each deconv_impl, the final stage's deconv, the head), the port's output
  within MODULE_ULPS bf16 ulps of the output's largest magnitude of JAX's
  (each rounding is at most half an ulp; a few of them meet on a value);
- the whole tiny() forward: the port's bf16-vs-JAX-bf16 error at most twice
  JAX's own bf16-vs-f32 error, plus a floor (the f32 parity tolerances of
  tests/_torch_helpers.py);
- the plain correlation of a bf16 map against JAX's rolled_corr: with
  allow_bf16 at D < 128, without it at D >= 128 (JAX's TPU dispatch takes
  its Pallas kernel there, which upcasts), at CORR_TOL;
- a slow learnability case as tests/test_overfit_localization.py:42-44;
- state_dict_from_jax of JAX variables built with every option of this
  slice loads strict=True.
JAX runs on the CPU with its Pallas dispatch rule emulated where the
TPU's routing matters (D >= 128 takes the upcasting kernel there)."""

import copy
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccvpe_tpu.ops.corr as jcorr
from _helpers import raw_ori_norm
from _torch_helpers import CORR_TOL, HEATMAP_ATOL, OUT_TOL, jax_variables, load_module, nchw, nhwc
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.nn import decoder as jdec
from ccvpe_tpu.nn import efficientnet as jeff
from ccvpe_tpu.ops.padding import traced_same_pads
from ccvpe_tpu.train import step as jstep
from ccvpe_tpu.utils.torch_convert import flatten
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import CVM, build_cvm
from ccvpe_tpu_torch.nn import decoder as tdec
from ccvpe_tpu_torch.nn import efficientnet as teff
from ccvpe_tpu_torch.ops import corr as tcorr
from ccvpe_tpu_torch.ops import corr_cuda
from ccvpe_tpu_torch.train import step as tstep
from ccvpe_tpu_torch.utils.convert import (backbone_state_dict, deconv_state_dict,
                                           double_conv_state_dict, state_dict_from_jax)

BF16 = jnp.bfloat16
MODULE_ULPS = 4
GRAD_ATOL = 5e-4     # the float32 gradient parity of tests/test_torch_train_step.py
# options of this slice, as bench.py:64-75 sets them
BENCH = dict(remat_backbone=True, remat_skip_blocks=2, deconv_impl="conv",
             compute_dtype="bfloat16", ori_window=160, corr_bf16=True)


def bf16_values(rng, shape, scale=1.0):
    """Normal values that bf16 holds exactly, as float32 numpy."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x, BF16).astype(jnp.float32))


def ulp_scale(want) -> float:
    """One bf16 ulp at the largest magnitude of `want` (8 significant bits)."""
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def assert_within_ulps(got, want, ulps=MODULE_ULPS):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= ulps * ulp_scale(want), (err, ulps * ulp_scale(want))


def _sub(flat, *path):
    n = len(path)
    return {k[n:]: v for k, v in flat.items() if k[:n] == path}


# --- per module ---

@pytest.fixture(scope="module")
def backbone():
    """JAX B0 variables (bf16 compute, circular) and the port's B0 loaded
    with them."""
    module = jeff.EfficientNetB0(circular=True, dtype=BF16)
    variables = jax_variables(module, np.zeros((2, 64, 96, 3), np.float32), False, seed=3)
    sd = backbone_state_dict(flatten(variables["params"]), flatten(variables["batch_stats"]))
    tmod = load_module(lambda: teff.EfficientNetB0(circular=True, compute_dtype=torch.bfloat16),
                       sd)
    return variables, tmod


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("index", [1, 4], ids=["stride2_block1", "residual_k5_block4"])
def test_mbconv_matches_jax(backbone, index, train):
    variables, tnet = backbone
    e, cin, cout, k, s = jeff.B0_BLOCK_SPECS[index]
    ph, pw = traced_same_pads()[1 + index]
    jmod = jeff.MBConv(expand_ratio=e, in_filters=cin, out_filters=cout, kernel=k, stride=s,
                       pad_h=ph, pad_w=pw, circular=True, drop_rate=0.0, dtype=BF16)
    block_vars = {c: variables[c][f"block{index}"] for c in ("params", "batch_stats")}
    x = bf16_values(np.random.default_rng(index), (2, 12, 20, cin))
    xj = jnp.asarray(x, BF16)
    if train:
        ref, _ = jmod.apply(block_vars, xj, True, mutable=["batch_stats"])
    else:
        ref = jmod.apply(block_vars, xj, False)
    block = copy.deepcopy(tnet._blocks[index]).train(train)   # train mode moves its stats
    with torch.no_grad():
        out = block(nchw(x).bfloat16())
    assert ref.dtype == BF16 and out.dtype == torch.bfloat16
    assert_within_ulps(nhwc(out.float()), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("impl", ["einsum", "conv"])
@pytest.mark.parametrize("final", [False, True], ids=["stage", "final_deconv"])
def test_decoder_stage_matches_jax(impl, final):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 6, 6, 33)).astype(np.float32)
    skip = None if final else bf16_values(rng, (2, 12, 12, 16))
    conv_out = None if final else 24
    module = jdec.DecoderStage(32, conv_out, dtype=BF16, deconv_impl=impl)
    skip_j = None if final else jnp.asarray(skip, BF16)
    variables = jax_variables(module, x, skip_j, seed=12)
    ref = module.apply(variables, x, skip_j)
    flat = flatten(variables["params"])
    deconv = load_module(lambda: tdec.Deconv2x2(33, 32, torch.bfloat16, impl),
                         deconv_state_dict(_sub(flat, "deconv")))
    conv = None if final else load_module(
        lambda: tdec.DoubleConv(32 + 16, 24, compute_dtype=torch.bfloat16),
        double_conv_state_dict(_sub(flat, "conv")))
    with torch.no_grad():
        out = tdec.decoder_stage(deconv, conv, nchw(x),
                                 None if final else nchw(skip).bfloat16())
    # the final stage's deconv gives float32, a stage's double conv bf16
    want_dtype = torch.float32 if final else torch.bfloat16
    assert out.dtype == want_dtype and ref.dtype == (jnp.float32 if final else BF16)
    got, want = nhwc(out.float()), np.asarray(ref.astype(jnp.float32))
    if final and impl == "einsum":
        # exact products of the rounded operands, float32 sums
        np.testing.assert_allclose(got, want, **OUT_TOL)
    else:
        assert_within_ulps(got, want)


def test_head_matches_jax():
    x = np.random.default_rng(13).normal(size=(2, 10, 12, 16)).astype(np.float32)
    module = jdec.HeadConv(16, 2, dtype=BF16)
    variables = jax_variables(module, x, seed=14)
    ref = module.apply(variables, x)
    tmod = load_module(lambda: tdec.HeadConv(16, 16, 2, torch.bfloat16),
                       double_conv_state_dict(flatten(variables["params"])))
    with torch.no_grad():
        out = tmod(nchw(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert_within_ulps(nhwc(out), np.asarray(ref))


# --- per module, the backward ---

def assert_grads_within_twice_jax_own(named):
    """(name, port, JAX bf16, JAX float32) gradients: the port's error to
    JAX's bf16 one, in the Frobenius norm, at most twice JAX's own
    bf16-vs-float32 error plus the float32 floor (GRAD_ATOL of the norm)."""
    for name, got, want, exact in named:
        got, want, exact = (np.asarray(a, np.float64) for a in (got, want, exact))
        assert got.shape == want.shape, name
        port_err = np.linalg.norm(got - want)
        own_err = np.linalg.norm(want - exact)
        assert port_err <= 2 * own_err + GRAD_ATOL * np.linalg.norm(want), (
            name, port_err, own_err)


def _mbconv_vjp(variables, index, dtype, x, ct):
    e, cin, cout, k, s = jeff.B0_BLOCK_SPECS[index]
    ph, pw = traced_same_pads()[1 + index]
    jmod = jeff.MBConv(expand_ratio=e, in_filters=cin, out_filters=cout, kernel=k, stride=s,
                       pad_h=ph, pad_w=pw, circular=True, drop_rate=0.0, dtype=dtype)
    stats = variables["batch_stats"][f"block{index}"]

    def f(params, xj):
        return jmod.apply({"params": params, "batch_stats": stats}, xj, True,
                          mutable=["batch_stats"])[0]

    y, vjp = jax.vjp(f, variables["params"][f"block{index}"], jnp.asarray(x, dtype))
    grad_p, grad_x = vjp(jnp.asarray(ct, y.dtype))
    full = dict(jax.tree.map(jnp.zeros_like, variables["params"]), **{f"block{index}": grad_p})
    sd = backbone_state_dict(flatten(full), flatten(variables["batch_stats"]))
    return np.asarray(grad_x.astype(jnp.float32)), {
        k[len(f"_blocks.{index}."):]: np.asarray(v) for k, v in sd.items()
        if k.startswith(f"_blocks.{index}.")}


@pytest.mark.parametrize("index", [1, 4], ids=["stride2_block1", "residual_k5_block4"])
def test_mbconv_backward_matches_jax(backbone, index):
    """Train mode (batch statistics in BN), a bf16 cotangent: the input's
    and every parameter's gradient (per-call weight casts, BN's float32
    statistics, the float32 SE sigmoid, the residual)."""
    variables, tnet = backbone
    cin = jeff.B0_BLOCK_SPECS[index][1]
    rng = np.random.default_rng(30 + index)
    x = bf16_values(rng, (2, 12, 20, cin))
    block = copy.deepcopy(tnet._blocks[index]).train(True)
    xt = nchw(x).bfloat16().requires_grad_()
    out = block(xt)
    ct = bf16_values(rng, nhwc(out.float()).shape)
    out.backward(nchw(ct).bfloat16())
    assert xt.grad.dtype == torch.bfloat16
    want_x, want = _mbconv_vjp(variables, index, BF16, x, ct)
    exact_x, exact = _mbconv_vjp(variables, index, jnp.float32, x, ct)
    assert_grads_within_twice_jax_own(
        [("x", nhwc(xt.grad.float()), want_x, exact_x)]
        + [(n, p.grad.numpy(), want[n], exact[n]) for n, p in block.named_parameters()])


def _stage_vjp(impl, dtype, final, x, skip, ct):
    module = jdec.DecoderStage(32, None if final else 24, dtype=dtype, deconv_impl=impl)
    skip_j = None if final else jnp.asarray(skip, dtype)
    variables = jax_variables(module, x, skip_j, seed=12)
    y, vjp = jax.vjp(lambda p, xj, sj: module.apply({"params": p}, xj, sj),
                     variables["params"], jnp.asarray(x), skip_j)
    grad_p, grad_x, grad_skip = vjp(jnp.asarray(ct, y.dtype))
    flat, grads = flatten(variables["params"]), flatten(grad_p)
    named = {"x": np.asarray(grad_x)}
    if not final:
        named["skip"] = np.asarray(grad_skip.astype(jnp.float32))
        named.update({f"conv.{k}": v for k, v in
                      double_conv_state_dict(_sub(grads, "conv")).items()})
    named.update({f"deconv.{k}": v for k, v in deconv_state_dict(_sub(grads, "deconv")).items()})
    return flat, named


@pytest.mark.parametrize("impl", ["einsum", "conv"])
@pytest.mark.parametrize("final", [False, True], ids=["stage", "final_deconv"])
def test_decoder_stage_backward_matches_jax(impl, final):
    """The stage's input, skip and parameter gradients under each
    deconv_impl's rounding (a float32 cotangent for the final deconv's
    float32 output, a bf16 one for a stage's double conv)."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 6, 6, 33)).astype(np.float32)
    skip = None if final else bf16_values(rng, (2, 12, 12, 16))
    ct = (rng.normal(size=(2, 12, 12, 32)).astype(np.float32) if final
          else bf16_values(rng, (2, 12, 12, 24)))
    flat, want = _stage_vjp(impl, BF16, final, x, skip, ct)
    _, exact = _stage_vjp(impl, jnp.float32, final, x, skip, ct)
    deconv = load_module(lambda: tdec.Deconv2x2(33, 32, torch.bfloat16, impl),
                         deconv_state_dict(_sub(flat, "deconv")))
    conv = None if final else load_module(
        lambda: tdec.DoubleConv(32 + 16, 24, compute_dtype=torch.bfloat16),
        double_conv_state_dict(_sub(flat, "conv")))
    xt = nchw(x).requires_grad_()
    st = None if final else nchw(skip).bfloat16().requires_grad_()
    out = tdec.decoder_stage(deconv, conv, xt, st)
    out.backward(nchw(ct).to(out.dtype))
    got = {"x": nhwc(xt.grad)}
    if not final:
        got["skip"] = nhwc(st.grad.float())
        got.update({f"conv.{n}": p.grad.numpy() for n, p in conv.named_parameters()})
    got.update({f"deconv.{n}": p.grad.numpy() for n, p in deconv.named_parameters()})
    assert set(got) == set(want)
    assert_grads_within_twice_jax_own([(n, got[n], want[n], exact[n]) for n in got])


# --- the correlation of a bf16 map ---

@pytest.mark.parametrize("d,length,shift", [(40, 32, 4), (80, 64, 8), (128, 128, 16),
                                            (320, 256, 16)])
def test_plain_correlation_of_bf16_map_matches_jax(d, length, shift):
    """D < 128: JAX's XLA path with allow_bf16 (G and S^2 rounded to bf16);
    D >= 128: its Pallas kernel's f32 cosine of the bf16 values, which is
    rolled_corr without allow_bf16 on the bf16 map."""
    rng = np.random.default_rng(d)
    sat = bf16_values(rng, (2, 5, 7, d))
    grd = rng.normal(size=(2, length)).astype(np.float32)
    sat_j = jnp.asarray(sat, BF16)
    ref = jcorr.rolled_corr(sat_j, jnp.asarray(grd), shift, 20,
                            allow_bf16=d < tcorr.BF16_ROUND_MAX_D)
    out = tcorr.rolled_corr(torch.from_numpy(sat).bfloat16(), torch.from_numpy(grd), shift, 20,
                            allow_bf16=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CORR_TOL)
    assert tcorr.bf16_rounding(torch.zeros(1, d, dtype=torch.bfloat16), True) == (d < 128)


@pytest.mark.parametrize("round_sq", [False, True])
def test_bf16_core_plain_versions_agree(round_sq):
    """corr_core_split_plain (the kernel's arithmetic: a bf16 S is its own
    TF32 hi) against corr_core_plain on a bf16 S, and, without rounding,
    the same out as float32 S.float()."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(bf16_values(rng, (2, 100, 72))).bfloat16()
    g = torch.randn(2, 20, 72, generator=torch.Generator().manual_seed(1))
    m = (torch.rand(20, 72, generator=torch.Generator().manual_seed(2)) > 0.3).float()
    plan = corr_cuda.corr_plan(2, 100, 72, 20, s_bytes=2)
    out, r = corr_cuda.corr_core_plain(s, g, m, need_r=True, round_sq=round_sq)
    split, split_r = corr_cuda.corr_core_split_plain(s, g, m, plan, need_r=True,
                                                     round_sq=round_sq)
    np.testing.assert_allclose(split.numpy(), out.numpy(), **CORR_TOL)
    np.testing.assert_allclose(split_r.numpy(), r.numpy(), rtol=1e-5)
    if not round_sq:
        assert torch.equal(out, corr_cuda.corr_core_plain(s.float(), g, m))


def test_plain_core_computes_in_the_descriptors_dtype():
    """A bf16 map upcasts to G's dtype: float32 on the model's path, float64
    where chip_smoke.py holds the kernel to a float64 product."""
    s = torch.randn(2, 9, 16, dtype=torch.float64)
    g = torch.randn(2, 4, 16, dtype=torch.float64)
    m = torch.ones(4, 16, dtype=torch.float64)
    assert corr_cuda.corr_core_plain(s, g, m).dtype == torch.float64
    assert corr_cuda.corr_core_plain(s.bfloat16(), g.float(), m.float()).dtype == torch.float32


def test_corr_gradient_comes_back_in_the_map_dtype():
    """corr_fwd's registered backward (two products in float32; S^2's rounding passes
    the gradient through) gives a bf16 map a bf16 gradient: autograd's
    float32 one within bf16's rounding (half an ulp, at most 2^-8 relative) plus
    float32 roundoff of sums taken in another order (1e-5 of the largest)."""
    rng = np.random.default_rng(6)
    s = torch.from_numpy(bf16_values(rng, (2, 30, 40))).bfloat16().requires_grad_()
    g = torch.randn(2, 20, 40, generator=torch.Generator().manual_seed(3))
    m = (torch.rand(20, 40, generator=torch.Generator().manual_seed(4)) > 0.3).float()
    w = torch.randn(2, 30, 20, generator=torch.Generator().manual_seed(5))
    (corr_cuda.corr_core_diff(s, g, m, True) * w).sum().backward()
    s32 = s.detach().float().requires_grad_()
    sq = s32 * s32
    sq = sq + (sq.detach().bfloat16().float() - sq.detach())     # rounded, straight through
    out = torch.bmm(s32, g.transpose(1, 2)) * torch.rsqrt(sq @ m.t())
    (out * w).sum().backward()
    assert s.grad.dtype == torch.bfloat16
    want = s32.grad.numpy()
    np.testing.assert_allclose(s.grad.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-5 * np.abs(want).max())


# --- the whole tiny() forward ---

def _tpu_dispatch_rolled_corr(orig):
    """JAX's rolled_corr as its TPU dispatch applies allow_bf16: only at
    D < 128 (D >= 128 takes the Pallas kernel, which upcasts)."""
    def rolled_corr(sat, grd, shift, num_bins, center=False, bins=None, eps=0.0,
                    ori_axis=None, allow_bf16=False):
        return orig(sat, grd, shift, num_bins, center, bins, eps, ori_axis,
                    allow_bf16 and sat.shape[-1] < tcorr.BF16_ROUND_MAX_D)
    return rolled_corr


@pytest.fixture(scope="module")
def jax_f32_forward():
    cfg = jcfg.tiny()
    rng = np.random.default_rng(21)
    grd = rng.normal(size=(2, *cfg.grd_size, 3)).astype(np.float32)
    sat = rng.normal(size=(2, *cfg.sat_size, 3)).astype(np.float32)
    model = JaxCVM(cfg)
    variables = jax_variables(model, grd[:1], sat[:1], False, seed=22)
    out = jax.jit(lambda v, g, s: model.apply(v, g, s, False))(variables, grd, sat)
    norm = raw_ori_norm(model, variables, grd, sat)
    return variables, grd, sat, jax.tree.map(np.asarray, out), norm


@pytest.mark.parametrize("over", [dict(deconv_impl="conv", corr_bf16=True),
                                  dict(deconv_impl="einsum", corr_bf16=False)],
                         ids=["conv_corr_bf16", "einsum"])
def test_forward_error_within_twice_jax_own(jax_f32_forward, over):
    variables, grd, sat, f32, raw_norm = jax_f32_forward
    jax_cfg = dataclasses.replace(jcfg.tiny(), compute_dtype="bfloat16", **over)
    model = JaxCVM(jax_cfg)
    with mock.patch.object(jcorr, "rolled_corr", _tpu_dispatch_rolled_corr(jcorr.rolled_corr)):
        ref = jax.tree.map(np.asarray, jax.jit(lambda v, g, s: model.apply(v, g, s, False))(
            variables, grd, sat))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    outs = {}
    for dtype in ("bfloat16", "float32"):
        port_cfg = dataclasses.replace(tcfg.tiny(), **dict(over, compute_dtype=dtype))
        with torch.inference_mode():
            outs[dtype] = build_cvm(port_cfg, "cpu", state_dict=sd)(torch.from_numpy(grd),
                                                                    torch.from_numpy(sat))
    out, port_f32 = outs["bfloat16"], outs["float32"]
    well = np.broadcast_to(raw_norm > 1e-2, f32.ori.shape)

    def named(o, r, f, p):
        pairs = [("logits", o.logits.numpy(), r.logits, f.logits, p.logits.numpy(),
                  OUT_TOL["atol"]),
                 ("heatmap", o.heatmap.numpy(), r.heatmap, f.heatmap, p.heatmap.numpy(),
                  HEATMAP_ATOL),
                 ("ori", o.ori.numpy()[well], r.ori[well], f.ori[well], p.ori.numpy()[well],
                  OUT_TOL["atol"])]
        return pairs + [(f"scores {i + 1}", a.numpy(), b, c, d.numpy(), CORR_TOL["atol"])
                        for i, (a, b, c, d) in enumerate(zip(
                            o.matching_scores, r.matching_scores, f.matching_scores,
                            p.matching_scores))]

    for name, got, want, exact, got_f32, floor in named(out, ref, f32, port_f32):
        assert got.dtype == np.float32 and got.shape == want.shape, name
        port_err = float(np.abs(got - want).max())
        own_err = float(np.abs(want - exact).max())
        assert own_err > 0, name                     # bf16 really ran in JAX
        assert port_err <= 2 * own_err + floor, (name, port_err, own_err)
        # and in the port: its bf16 output is as far from its own float32
        # one as JAX's is (a port that ignored compute_dtype would sit at
        # float32 roundoff from it)
        port_own = float(np.abs(got - got_f32).max())
        assert port_own >= own_err / 2, (name, port_own, own_err)


# --- the bf16 train configuration's backward ---

def _train_batch(cfg, b=2, seed=13):
    rng = np.random.default_rng(seed)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    return jstep.Batch(
        grd=rng.integers(0, 256, (b, hg, wg, 3), dtype=np.uint8),
        sat=rng.integers(0, 256, (b, hs, ws, 3), dtype=np.uint8),
        row_offset=rng.uniform(-60, 60, b).astype(np.float32),
        col_offset=rng.uniform(-60, 60, b).astype(np.float32),
        angle_deg=rng.uniform(0, 360, b).astype(np.float32))


def test_bf16_train_gradients_match_jax():
    """One loss backward under bench.py's options (remat 'save_dw' with the
    decoder's, the window, conv deconv, bf16, corr_bf16) on tiny(sat=256),
    drop-connect off in both packages, against the JAX package's loss_fn.

    A whole model's bf16 gradient is far from its float32 one: at tiny()
    JAX's own error is ~30% of a tensor's norm (the median over tensors),
    and one tensor's own error is one draw of that noise, small by chance
    for a scalar whose gradient is a cancelling sum (a ground head's
    h_bias). JAX on the CPU also keeps excess precision inside XLA's
    fusions where the port rounds each op to bf16. So, in Frobenius norms:
    - over all parameters, the port's error to JAX's bf16 gradient at most
      twice JAX's own bf16-vs-float32 error;
    - per parameter tensor, the port's bf16 error to JAX's float32 gradient
      at most twice JAX's own, counted as at least the median relative own
      error of the model's tensors, plus the float32 floor (GRAD_ATOL);
    - the port's bf16 gradient is as far from its own float32 one as half
      JAX's own error, over all parameters (bf16 ran in the backward).
    The per-module backward tests above hold each op's rounding closely."""
    over = dict(BENCH, remat_policy="save_dw", remat_decoder=True)
    dtypes = ("bfloat16", "float32")
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
    got = {}
    for d in dtypes:
        cfg = dataclasses.replace(tcfg.tiny(sat=256), **dict(over, compute_dtype=d))
        with mock.patch.object(teff, "DROP_CONNECT_RATE", 0.0):
            state = tstep.create_train_state(cfg, tcfg.TrainConfig(), device="cpu",
                                             state_dict=sd)
        state, _ = tstep.make_train_step(cfg, tcfg.TrainConfig())(
            state, tstep.Batch(*map(torch.from_numpy, batch)))
        got[d] = {n: p.grad.numpy().astype(np.float64) for n, p in
                  state.model.named_parameters()}
    names = sorted(got["bfloat16"])
    assert set(names) <= set(want["bfloat16"])
    p16, p32 = got["bfloat16"], got["float32"]
    j16, j32 = ({n: want[d][n].numpy().astype(np.float64) for n in names} for d in dtypes)
    fro = np.linalg.norm

    def total(a, b):
        return np.sqrt(sum(fro(a[n] - b[n]) ** 2 for n in names))

    own = total(j16, j32)
    assert total(p16, j16) <= 2 * own, (total(p16, j16), own)
    assert total(p16, p32) >= own / 2, (total(p16, p32), own)
    rho = float(np.median([fro(j16[n] - j32[n]) / fro(j32[n]) for n in names]))
    for n in names:
        assert p16[n].shape == j16[n].shape, n
        allowed = 2 * max(fro(j16[n] - j32[n]), rho * fro(j32[n])) + GRAD_ATOL * fro(j32[n])
        assert fro(p16[n] - j32[n]) <= allowed, (n, fro(p16[n] - j32[n]), allowed)


# --- learnability, and the parameter tree ---

@pytest.mark.slow
def test_bf16_localization_becomes_learnable():
    """tests/test_overfit_localization.py:42-44 on the port in bf16: 50 steps
    on a batch whose aerial image holds a bright blob at the GT."""
    from test_overfit_localization import learnable_batch
    from ccvpe_tpu_torch.ops import pose
    from ccvpe_tpu_torch.train import step as tstep
    cfg = dataclasses.replace(tcfg.tiny(), compute_dtype="bfloat16")
    train_cfg = tcfg.TrainConfig(batch_size=8, learning_rate=1e-3)
    state = tstep.create_train_state(cfg, train_cfg, torch.Generator().manual_seed(17),
                                     device="cpu")
    step = tstep.make_train_step(cfg, train_cfg)
    eval_step = tstep.make_eval_step(state.model)
    batch = tstep.Batch(*(torch.tensor(np.asarray(v)) for v in learnable_batch(cfg, 8, 0)))
    hs, ws = cfg.sat_size

    def median_err():
        heatmap, _ = eval_step(batch.grd, batch.sat)
        rows, cols, _ = pose.decode_pose(heatmap, torch.zeros(8, hs, ws, 2))
        gt_r, gt_c = pose.gt_location(hs, ws, batch.row_offset.numpy(),
                                      batch.col_offset.numpy())
        return float(np.median(np.hypot(gt_r - rows.numpy(), gt_c - cols.numpy())))

    err0 = median_err()
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        state, m = step(state, batch, gen)
    err1 = median_err()
    assert np.isfinite(float(m["loss"]))
    assert err1 < max(6.0, err0 * 0.25), (err0, err1)


@pytest.mark.parametrize("policy", ["none", "save_dw"])
def test_state_dict_from_jax_loads_strict_with_every_option(policy):
    """None of this slice's options changes the parameter tree."""
    over = dict(BENCH, remat_policy=policy, remat_decoder=True)
    cfg = dataclasses.replace(jcfg.tiny(sat=256), **over)
    variables = jax_variables(JaxCVM(cfg), np.zeros((1, *cfg.grd_size, 3), np.float32),
                              np.zeros((1, *cfg.sat_size, 3), np.float32), False, seed=1)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    model = CVM(dataclasses.replace(tcfg.tiny(sat=256), **over)).to_empty(device="cpu")
    assert not model.load_state_dict(sd, strict=True).missing_keys
