"""Port vs JAX: the edge-fix circular conv (circular_impl='edgefix',
ccvpe_tpu_torch/ops/padding.py::conv_circular_same against
ccvpe_tpu/ops/padding.py::conv_circular_same), on the CPU in float32.

tests/test_circular_conv.py's parametrisation (every (kernel, stride) of
B0 and the narrowest widths, depthwise and dense), each against the port's
materialized wrap ('wrap': pad_same, then the conv) within the JAX suite's
1e-6 for edgefix against wrap, and against the JAX function within 1e-5
(torch's and XLA's convs sum the taps in another order: 1.5e-6 on outputs
near 5 at k = 5); the gradients against wrap's and JAX's (1e-5, as
tests/test_circular_conv.py); the backbone under 'edgefix' equal to 'wrap'
on the same weights (1e-6), and to the JAX backbone under 'edgefix' at the
port's float32 parity tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_helpers import OUT_TOL, jax_variables, load_module, nchw, nhwc
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.nn import efficientnet as jeff
from ccvpe_tpu.ops import padding as jpad
from ccvpe_tpu.utils.torch_convert import flatten
from ccvpe_tpu_torch.nn import efficientnet as teff
from ccvpe_tpu_torch.ops import padding as tpad
from ccvpe_tpu_torch.utils.convert import backbone_state_dict

# tests/test_circular_conv.py:33-34
CASES = [(3, 1, 16, 8), (3, 2, 16, 8), (5, 1, 16, 8), (5, 2, 16, 8),
         (3, 1, 7, 4), (5, 1, 7, 4), (5, 2, 7, 4), (3, 2, 8, 4)]
TOL = dict(rtol=1e-6, atol=1e-6)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _wrap_conv(x, weight, stride, pad_h, pad_w, groups):
    """The port's 'wrap': W wrapped by pad_same, H zero-padded, then the conv."""
    return F.conv2d(tpad.pad_same(x, pad_h, pad_w, circular=True), weight, None, stride,
                    groups=groups)


def _case(seed, k, s, w, c, g, h=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    kernel = rng.normal(size=(k, k, c // g, c)).astype(np.float32)
    return x, kernel, torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("k,s,w,c", CASES)
@pytest.mark.parametrize("groups", ["depthwise", "dense"])
def test_conv_circular_same_matches_jax_and_wrap(k, s, w, c, groups):
    g = c if groups == "depthwise" else 1
    pad_h = pad_w = tpad.same_pad_1d(224, k, s)
    x, kernel, weight = _case(k * 10 + s, k, s, w, c, g)
    want = np.asarray(jpad.conv_circular_same(jnp.asarray(x), jnp.asarray(kernel), s, pad_h,
                                              pad_w, groups=g))
    got = tpad.conv_circular_same(nchw(x), weight, s, pad_h, pad_w, groups=g)
    np.testing.assert_allclose(nhwc(got), want, **JAX_TOL)
    wrap = _wrap_conv(nchw(x), weight, s, pad_h, pad_w, g)
    assert got.shape == wrap.shape
    np.testing.assert_allclose(got.numpy(), wrap.numpy(), **TOL)


def test_unwrapped_conv_is_the_plain_conv():
    """pad_w (0, 0): no edge to fix, the zero-padded conv alone."""
    x, _, weight = _case(1, 1, 1, 6, 4, 1)
    got = tpad.conv_circular_same(nchw(x), weight, 1, (0, 0), (0, 0))
    assert torch.equal(got, F.conv2d(nchw(x), weight))


def test_too_narrow_raises():
    x = torch.zeros(1, 2, 5, 2)
    with pytest.raises(ValueError, match="narrow"):
        tpad.conv_circular_same(x, torch.zeros(2, 2, 5, 5), 1, (2, 2), (2, 2))


def test_conv_circular_same_grads_match():
    """tests/test_circular_conv.py:54-73: the input's and the kernel's
    gradients under a random cotangent, against wrap's and JAX's."""
    k, s = 5, 1
    pad = tpad.same_pad_1d(224, k, s)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 10, 4)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 4, 4)).astype(np.float32)
    cot = rng.normal(size=(2, 6, 10, 4)).astype(np.float32)
    jx, jw = jax.grad(lambda x, w: jnp.sum(jpad.conv_circular_same(x, w, s, pad, pad) * cot),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kernel))

    def grads(fn):
        xs = nchw(x).requires_grad_()
        ws = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))).requires_grad_()
        (fn(xs, ws, s, pad, pad, 1) * nchw(cot)).sum().backward()
        return nhwc(xs.grad), ws.grad.numpy().transpose(2, 3, 1, 0)

    (ex, ew), (wx, ww) = grads(tpad.conv_circular_same), grads(_wrap_conv)
    for got, want in ((ex, wx), (ew, ww), (ex, np.asarray(jx)), (ew, np.asarray(jw))):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_backbone_edgefix_equals_wrap_and_jax():
    """The B0 backbone, circular, on the same weights: 'edgefix' equal to
    'wrap' (head features and all 16 block outputs), and to the JAX
    backbone under 'edgefix'; the state dict the same for both impls."""
    x = np.random.default_rng(0).normal(size=(1, 64, 128, 3)).astype(np.float32)
    jmod = jeff.EfficientNetB0(circular=True, circular_impl="edgefix")
    variables = jax_variables(jmod, x, False, seed=3)
    want, want_ms = jax.jit(lambda v, x: jmod.apply(v, x, False))(variables, x)
    sd = backbone_state_dict(flatten(variables["params"]), flatten(variables["batch_stats"]))
    nets = {impl: load_module(lambda impl=impl: teff.EfficientNetB0(circular=True,
                                                                    circular_impl=impl), sd)
            for impl in ("wrap", "edgefix")}
    assert nets["edgefix"]._conv_stem.edgefix and not nets["wrap"]._conv_stem.edgefix
    with torch.no_grad():
        (yw, msw), (ye, mse) = (nets[i](nchw(x)) for i in ("wrap", "edgefix"))
    np.testing.assert_allclose(ye.numpy(), yw.numpy(), **TOL)
    for a, b in zip(mse, msw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    np.testing.assert_allclose(nhwc(ye), np.asarray(want), **OUT_TOL)
    for a, b in zip(mse, want_ms):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), **OUT_TOL)
