"""Port vs JAX: Deconv2x2, DoubleConv, HeadConv and the plain DecoderStage
(with and without skip, and the final stage without conv)."""

import numpy as np
import pytest
import torch

from _torch_helpers import OUT_TOL, jax_variables, load_module, nchw, nhwc
from ccvpe_tpu.nn import decoder as jdec
from ccvpe_tpu.utils.torch_convert import flatten
from ccvpe_tpu_torch.nn import decoder as tdec
from ccvpe_tpu_torch.utils.convert import deconv_state_dict, double_conv_state_dict


def _sub(flat, *path):
    n = len(path)
    return {k[n:]: v for k, v in flat.items() if k[:n] == path}


def test_deconv2x2_matches_jax(rng):
    x = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    module = jdec.Deconv2x2(5)
    variables = jax_variables(module, x, seed=5)
    ref = np.asarray(module.apply(variables, x))
    tmod = load_module(lambda: tdec.Deconv2x2(6, 5),
                       deconv_state_dict(flatten(variables["params"])))
    out = nhwc(tmod(nchw(x)))
    assert out.shape == (2, 6, 8, 5)
    np.testing.assert_allclose(out, ref, **OUT_TOL)


@pytest.mark.parametrize("head", [False, True], ids=["double_conv", "head_conv"])
def test_double_and_head_conv_match_jax(head, rng):
    x = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    module = jdec.HeadConv(8, 2) if head else jdec.DoubleConv(8)
    variables = jax_variables(module, x, seed=6)
    ref = np.asarray(module.apply(variables, x))
    factory = (lambda: tdec.HeadConv(7, 8, 2)) if head else (lambda: tdec.DoubleConv(7, 8))
    tmod = load_module(factory, double_conv_state_dict(flatten(variables["params"])))
    out = tmod(nchw(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(nhwc(out), ref, **OUT_TOL)


@pytest.mark.parametrize("skip_ch,conv_out", [(3, 6), (None, 6), (None, None)],
                         ids=["skip", "no_skip", "final"])
def test_decoder_stage_matches_jax(skip_ch, conv_out, rng):
    x = rng.normal(size=(2, 3, 3, 5)).astype(np.float32)
    skip = (None if skip_ch is None
            else rng.normal(size=(2, 6, 6, skip_ch)).astype(np.float32))
    module = jdec.DecoderStage(4, conv_out)
    variables = jax_variables(module, x, skip, seed=7)
    ref = np.asarray(module.apply(variables, x, skip))
    flat = flatten(variables["params"])
    deconv = load_module(lambda: tdec.Deconv2x2(5, 4),
                         deconv_state_dict(_sub(flat, "deconv")))
    conv = None
    if conv_out is not None:
        conv = load_module(lambda: tdec.DoubleConv(4 + (skip_ch or 0), conv_out),
                           double_conv_state_dict(_sub(flat, "conv")))
    out = tdec.decoder_stage(deconv, conv, nchw(x), None if skip is None else nchw(skip))
    np.testing.assert_allclose(nhwc(out), ref, **OUT_TOL)
