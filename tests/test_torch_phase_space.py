"""Port vs JAX: phase-space (space-to-depth) fine decoder stages
(ccvpe_tpu_torch/ops/phase_space.py against ccvpe_tpu/ops/phase_space.py,
ModelConfig.phase_space_min_res), on the CPU in float32.

Each case of tests/test_phase_space.py runs the JAX function and the
port's on the same numpy-seeded inputs (the port's tensors NCHW, its
weights in torch's layouts). Tolerances: the JAX suite's own for the
packed ops against the fine ones (1e-5 a deconv, 1e-4 a packed conv, 2e-4
a stage, 5e-3 gradients through two stacked convs), since the two packages
sum each conv in another order; the model, phased against unphased, as
tests/test_phase_space.py:189-228 holds JAX's (heatmap 1e-5, logits,
scores and ori 2e-4, gradients 5e-4 of each tensor's max); phased port
against phased JAX at the port's float32 parity tolerances
(tests/_torch_helpers.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _helpers import assert_ori_close
from _torch_helpers import CORR_TOL, HEATMAP_ATOL, OUT_TOL, jax_variables, nchw, nhwc
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.ops import phase_space as jps
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import CVM, build_cvm
from ccvpe_tpu_torch.ops import phase_space as tps
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax


def _n(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def deconv_w(k):
    """JAX Deconv2x2 kernel (2, 2, Cin, Cd) -> ConvTranspose2d's (Cin, Cd, 2, 2)."""
    return t(k.transpose(2, 3, 0, 1))


def conv_w(w):
    """HWIO -> OIHW."""
    return t(w.transpose(3, 2, 0, 1))


def test_space_depth_roundtrip_and_layout():
    x = _n(np.random.default_rng(0), 2, 8, 12, 5)
    packed = tps.space_to_depth(nchw(x))
    np.testing.assert_array_equal(nhwc(packed), np.asarray(jps.space_to_depth(jnp.asarray(x))))
    assert torch.equal(tps.depth_to_space(packed, 5), nchw(x))


def test_deconv_packed_matches_jax():
    rng = np.random.default_rng(1)
    x, k, b = _n(rng, 2, 6, 7, 9), _n(rng, 2, 2, 9, 5), _n(rng, 5)
    want = np.asarray(jps.deconv2x2_packed(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = nhwc(tps.deconv2x2_packed(nchw(x), deconv_w(k), t(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pi,pj", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_phase_conv_kernel_is_jax_kernel(pi, pj):
    """The packed 3x3 kernel builder, split [deconv | skip] channels, each
    output phase: the JAX kernel in torch's layout, to the bit."""
    w = _n(np.random.default_rng(2), 3, 3, 5 + 3, 6)
    want = np.asarray(jps._phase_conv_kernel(jnp.asarray(w), pi, pj, 5, 3))
    got = tps.phase_conv_kernel(conv_w(w), pi, pj, 5, 3).numpy()
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("impl", ["onebig", "phase4"])
@pytest.mark.parametrize("hw,cin,cout", [((6, 8), 7, 5), ((4, 4), 3, 11)])
def test_conv3x3_packed_matches_jax(impl, hw, cin, cout):
    rng = np.random.default_rng(3)
    h, w = hw
    fine, wt, b = _n(rng, 2, 2 * h, 2 * w, cin), _n(rng, 3, 3, cin, cout), _n(rng, cout)
    want = np.asarray(jps.conv3x3_packed(jps.space_to_depth(jnp.asarray(fine)), jnp.asarray(wt),
                                         jnp.asarray(b), impl=impl))
    got = tps.conv3x3_packed(tps.space_to_depth(nchw(fine)), conv_w(wt), t(b), impl=impl)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["onebig", "phase4"])
def test_conv3x3_packed_split_skip_layout(impl):
    """A packed [4*cd deconv | 4*cs skip] input, the interleave on the
    weights: JAX's result, and the fine conv on the concatenated map."""
    rng = np.random.default_rng(4)
    cd, cs, cout, h, w = 5, 3, 6, 4, 6
    fd, fs = _n(rng, 2, 2 * h, 2 * w, cd), _n(rng, 2, 2 * h, 2 * w, cs)
    wt, b = _n(rng, 3, 3, cd + cs, cout), _n(rng, cout)
    z = jnp.concatenate([jps.space_to_depth(jnp.asarray(fd)), jps.space_to_depth(jnp.asarray(fs))],
                        axis=-1)
    want = np.asarray(jps.conv3x3_packed(z, jnp.asarray(wt), jnp.asarray(b), cd=cd, cs=cs,
                                         impl=impl))
    zt = torch.cat([tps.space_to_depth(nchw(fd)), tps.space_to_depth(nchw(fs))], dim=1)
    got = tps.conv3x3_packed(zt, conv_w(wt), t(b), cd=cd, cs=cs, impl=impl)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)
    fine = torch.nn.functional.conv2d(torch.cat([nchw(fd), nchw(fs)], 1), conv_w(wt), t(b),
                                      padding=1)
    np.testing.assert_allclose(tps.depth_to_space(got, cout).numpy(), fine.numpy(), rtol=1e-4,
                               atol=1e-4)


def _stage_inputs(rng, cin, cd, cs, cout, h, w, b=2):
    x = _n(rng, b, h, w, cin)
    skip = _n(rng, b, 2 * h, 2 * w, cs) if cs else None
    ws = (_n(rng, 2, 2, cin, cd), _n(rng, cd), _n(rng, 3, 3, cd + cs, cout), _n(rng, cout),
          _n(rng, 3, 3, cout, cout), _n(rng, cout))
    return x, skip, ws


def _torch_stage_ws(ws):
    dk, db, wa, ba, wb, bb = ws
    return deconv_w(dk), t(db), conv_w(wa), t(ba), conv_w(wb), t(bb)


@pytest.mark.parametrize("impl", ["onebig", "phase4"])
@pytest.mark.parametrize("with_skip", [True, False])
def test_phase_stage_matches_jax(impl, with_skip):
    x, skip, ws = _stage_inputs(np.random.default_rng(5), 9, 6, 4 if with_skip else 0, 5, 4, 6)
    want = np.asarray(jps.phase_stage(jnp.asarray(x), None if skip is None else jnp.asarray(skip),
                                      *map(jnp.asarray, ws), dtype=jnp.float32, impl=impl))
    got = tps.phase_stage(nchw(x), None if skip is None else nchw(skip), *_torch_stage_ws(ws),
                          dtype=torch.float32, impl=impl)
    np.testing.assert_allclose(nhwc(got), want, rtol=2e-4, atol=2e-4)


def test_phase_stage_deconv_only():
    rng = np.random.default_rng(6)
    x, k, b = _n(rng, 2, 4, 4, 7), _n(rng, 2, 2, 7, 3), _n(rng, 3)
    want = np.asarray(jps.phase_stage(jnp.asarray(x), None, jnp.asarray(k), jnp.asarray(b), None,
                                      None, None, None, dtype=jnp.float32, unpack=False))
    got = tps.phase_stage(nchw(x), None, deconv_w(k), t(b), None, None, None, None,
                          dtype=torch.float32, unpack=False)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="skip"):
        tps.phase_stage(nchw(x), torch.zeros(2, 2, 8, 8), deconv_w(k), t(b), None, None, None,
                        None, dtype=torch.float32)


def test_phase_stage_grads_match_jax():
    """Autograd through the port's packed stage == jax.grad through JAX's."""
    x, skip, ws = _stage_inputs(np.random.default_rng(7), 5, 4, 3, 4, 4, 4, b=1)
    dk, db, wa, ba, wb, bb = map(jnp.asarray, ws)

    def loss(x, dk, wa, wb):
        return jnp.sum(jnp.sin(jps.phase_stage(x, jnp.asarray(skip), dk, db, wa, ba, wb, bb,
                                               dtype=jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(jnp.asarray(x), dk, wa, wb)
    leaves = [nchw(x).requires_grad_()] + [w.requires_grad_() for w in _torch_stage_ws(ws)]
    xs, tdk, tdb, twa, tba, twb, tbb = leaves
    torch.sin(tps.phase_stage(xs, nchw(skip), tdk, tdb, twa, tba, twb, tbb,
                              dtype=torch.float32)).sum().backward()
    got = (nhwc(xs.grad), tdk.grad.numpy().transpose(2, 3, 0, 1),
           twa.grad.numpy().transpose(2, 3, 1, 0), twb.grad.numpy().transpose(2, 3, 1, 0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-3, atol=5e-3)


def test_phase_stage_in_bf16_rounds_as_jax():
    """dtype=bfloat16: each stage result rounded to bf16 as JAX's is,
    within two bf16 ulps of the output's largest magnitude."""
    from test_torch_bf16 import assert_within_ulps
    x, skip, ws = _stage_inputs(np.random.default_rng(8), 9, 6, 4, 5, 4, 6)
    want = jps.phase_stage(jnp.asarray(x), jnp.asarray(skip), *map(jnp.asarray, ws),
                           dtype=jnp.bfloat16)
    got = tps.phase_stage(nchw(x), nchw(skip), *_torch_stage_ws(ws), dtype=torch.bfloat16)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert_within_ulps(nhwc(got.float()), np.asarray(want.astype(jnp.float32)), ulps=2)


# --- the model (ModelConfig.phase_space_min_res) ---

PHASED = dict(phase_space_min_res=32)


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = jcfg.tiny()
    rng = np.random.default_rng(11)
    grd = _n(rng, 2, *cfg.grd_size, 3)
    sat = _n(rng, 2, *cfg.sat_size, 3)
    variables = jax_variables(JaxCVM(cfg), grd[:1], sat[:1], False, seed=17)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    # the raw ori head's norm (tests/_helpers.py::raw_ori_norm), jitted
    _, inter = jax.jit(lambda v, g, s: JaxCVM(cfg).apply(
        v, g, s, False, capture_intermediates=lambda mdl, _: mdl.name == "ori_head"))(
            variables, grd, sat)
    norm = np.linalg.norm(np.asarray(jax.tree.leaves(inter["intermediates"])[0]), axis=-1,
                          keepdims=True)
    return variables, sd, grd, sat, norm


def test_state_dict_keys_are_unchanged(tiny_pair):
    """The phased model's parameters are the fine stages': the same state
    dict keys, and state_dict_from_jax of the phased JAX model's variables
    loads with strict=True."""
    _, sd, grd, sat, _ = tiny_pair
    phased = dataclasses.replace(tcfg.tiny(), **PHASED)
    assert set(CVM(phased).state_dict()) == set(CVM(tcfg.tiny()).state_dict())
    jvars = jax_variables(JaxCVM(dataclasses.replace(jcfg.tiny(), **PHASED)), grd[:1], sat[:1],
                          False, seed=17)
    jsd = state_dict_from_jax(jvars["params"], jvars["batch_stats"])
    assert set(jsd) == set(sd)
    model = CVM(phased).to_empty(device="cpu")
    assert not model.load_state_dict(jsd, strict=True).missing_keys


def _forward(over, sd, grd, sat):
    model = build_cvm(dataclasses.replace(tcfg.tiny(), **over), "cpu", state_dict=sd)
    with torch.inference_mode():
        return model(torch.from_numpy(grd), torch.from_numpy(sat))


def test_model_forward_matches_unphased(tiny_pair):
    _, sd, grd, sat, rn = tiny_pair
    base, phased = _forward({}, sd, grd, sat), _forward(PHASED, sd, grd, sat)
    np.testing.assert_allclose(phased.heatmap.numpy(), base.heatmap.numpy(), atol=1e-5)
    np.testing.assert_allclose(phased.logits.numpy(), base.logits.numpy(), atol=2e-4)
    assert_ori_close(phased.ori.numpy(), base.ori.numpy(), rn, atol=2e-4)
    for a, b in zip(phased.matching_scores, base.matching_scores):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def test_model_grads_match_unphased(tiny_pair):
    _, sd, grd, sat, _ = tiny_pair

    def grads(over):
        model = build_cvm(dataclasses.replace(tcfg.tiny(), **over), "cpu", state_dict=sd)
        out = model(torch.from_numpy(grd), torch.from_numpy(sat))
        loss = ((out.heatmap ** 2).mean() * 1e4 + (out.ori ** 2).mean()
                + sum((s ** 2).mean() for s in out.matching_scores))
        loss.backward()
        return {n: p.grad.numpy() for n, p in model.named_parameters()}

    base, phased = grads({}), grads(PHASED)
    assert set(base) == set(phased)
    for name, a in base.items():
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(phased[name] / scale, a / scale, atol=5e-4, err_msg=name)


def test_model_forward_matches_jax_phased(tiny_pair):
    """The port's phased forward against the JAX package's phased forward."""
    variables, sd, grd, sat, rn = tiny_pair
    model = JaxCVM(dataclasses.replace(jcfg.tiny(), **PHASED))
    ref = jax.tree.map(np.asarray, jax.jit(lambda v, g, s: model.apply(v, g, s, False))(
        variables, grd, sat))
    out = _forward(PHASED, sd, grd, sat)
    np.testing.assert_allclose(out.logits.numpy(), ref.logits, **OUT_TOL)
    np.testing.assert_allclose(out.heatmap.numpy(), ref.heatmap, atol=HEATMAP_ATOL)
    assert_ori_close(out.ori.numpy(), ref.ori, rn)
    for a, b in zip(out.matching_scores, ref.matching_scores):
        np.testing.assert_allclose(a.numpy(), b, **CORR_TOL)
