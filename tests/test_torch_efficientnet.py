"""Port vs JAX: EfficientNet-B0 (eval mode), plain and circular, head
features and all 16 block outputs, with JAX weights carried across."""

import jax
import numpy as np
import pytest
import torch

from _torch_helpers import OUT_TOL, jax_variables, load_module, nchw, nhwc
from ccvpe_tpu.nn.efficientnet import EfficientNetB0 as JaxB0
from ccvpe_tpu.utils.torch_convert import flatten
from ccvpe_tpu_torch.nn.efficientnet import EfficientNetB0
from ccvpe_tpu_torch.ops.padding import b0_layer_sizes
from ccvpe_tpu_torch.utils.convert import backbone_state_dict

SHAPE = (2, 40, 72, 3)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "circular"])
def outputs(request):
    circular = request.param
    x = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    module = JaxB0(circular=circular)
    variables = jax_variables(module, x, False, seed=2)
    feat, blocks = jax.jit(lambda v, x: module.apply(v, x, False))(variables, x)
    sd = backbone_state_dict(flatten(variables["params"]),
                             flatten(variables["batch_stats"]))
    tmod = load_module(lambda: EfficientNetB0(circular=circular), sd)
    with torch.inference_mode():
        tfeat, tblocks = tmod(nchw(x))
    return (np.asarray(feat), [np.asarray(b) for b in blocks],
            nhwc(tfeat), [nhwc(b) for b in tblocks])


def test_head_features_match_jax(outputs):
    feat, _, tfeat, _ = outputs
    assert tfeat.shape == feat.shape
    np.testing.assert_allclose(tfeat, feat, **OUT_TOL)


def test_block_outputs_match_jax(outputs):
    _, blocks, _, tblocks = outputs
    assert len(tblocks) == len(blocks) == 16
    for i, (a, b) in enumerate(zip(tblocks, blocks)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, err_msg=f"block {i}", **OUT_TOL)


def test_block_sizes_follow_static_pads(outputs):
    _, blocks, _, _ = outputs
    assert [b.shape[1:3] for b in blocks] == list(b0_layer_sizes(SHAPE[1:3])[1:])
