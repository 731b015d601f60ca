"""Port vs JAX: EfficientNet-B0, plain and circular, head features and all
16 block outputs, with JAX weights carried across; in eval mode and in
train mode (batch statistics, running stats, drop-connect)."""

from unittest import mock

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


# --- train mode: batch statistics, the flax running-stat update, drop-connect ---

TRAIN_SHAPE = (2, 64, 96, 3)     # a 2 x 3 head map: n = 12 samples per head-BN channel

@pytest.fixture(scope="module")
def train_outputs():
    """Train-mode forward of both packages from the same weights, with
    drop-connect off in both (tests/test_train_parity.py:55); the port's
    head-BN input is captured to replay torch's own running-stat update."""
    import ccvpe_tpu.nn.efficientnet as jeff
    import ccvpe_tpu_torch.nn.efficientnet as teff

    x = np.random.default_rng(3).normal(size=TRAIN_SHAPE).astype(np.float32)
    module = JaxB0(circular=True)
    variables = jax_variables(module, x, False, seed=4)
    with mock.patch.object(jeff, "DROP_CONNECT_RATE", 0.0):
        (feat, blocks), mutated = jax.jit(lambda v, x: module.apply(
            v, x, True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)}))(
                variables, x)
    sd = backbone_state_dict(flatten(variables["params"]), flatten(variables["batch_stats"]))
    new_sd = backbone_state_dict(flatten(variables["params"]), flatten(mutated["batch_stats"]))
    with mock.patch.object(teff, "DROP_CONNECT_RATE", 0.0):
        tmod = load_module(lambda: EfficientNetB0(circular=True), sd).train()
    head_in = {}
    tmod._bn1.register_forward_hook(lambda m, i, o: head_in.update(x=i[0].detach()))
    tfeat, tblocks = tmod(nchw(x))
    return dict(feat=np.asarray(feat), blocks=[np.asarray(b) for b in blocks],
                tfeat=nhwc(tfeat), tblocks=[nhwc(b) for b in tblocks], new_sd=new_sd,
                old_sd=sd, tsd=tmod.state_dict(), head_in=head_in["x"])


def test_train_mode_outputs_match_jax(train_outputs):
    o = train_outputs
    np.testing.assert_allclose(o["tfeat"], o["feat"], **OUT_TOL)
    for i, (a, b) in enumerate(zip(o["tblocks"], o["blocks"])):
        np.testing.assert_allclose(a, b, err_msg=f"block {i}", **OUT_TOL)


# The JAX suite's tolerances on the BN EMA against torch
# (tests/test_train_parity.py:82-85).
MEAN_ATOL, VAR_RTOL, VAR_ATOL = 1e-5, 2e-4, 1e-5


def test_train_mode_running_stats_match_flax(train_outputs):
    o = train_outputs
    names = [k for k in o["new_sd"] if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 49      # stem, 16 blocks' two or three BNs, head
    for k in names:
        got = o["tsd"][k].numpy()
        want = np.asarray(o["new_sd"][k])
        assert not np.array_equal(want, np.asarray(o["old_sd"][k])), k   # it moved
        if k.endswith("running_mean"):
            np.testing.assert_allclose(got, want, atol=MEAN_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=VAR_RTOL, atol=VAR_ATOL, err_msg=k)


def test_unbiased_variance_update_would_fail(train_outputs):
    """torch's own BatchNorm update (unbiased batch variance) misses flax's
    head-BN running var at the tolerance above: n = B*h*w = 12 here."""
    import torch.nn.functional as F

    o = train_outputs
    x = o["head_in"]
    n = x.shape[0] * x.shape[2] * x.shape[3]
    assert n == 12
    mean = torch.tensor(np.asarray(o["old_sd"]["_bn1.running_mean"]))
    var = torch.tensor(np.asarray(o["old_sd"]["_bn1.running_var"]))
    F.batch_norm(x, mean, var, training=True, momentum=0.01, eps=1e-3)
    want = np.asarray(o["new_sd"]["_bn1.running_var"])
    assert not np.allclose(var.numpy(), want, rtol=VAR_RTOL, atol=VAR_ATOL)
    np.testing.assert_allclose(o["tsd"]["_bn1.running_var"].numpy(), want,
                               rtol=VAR_RTOL, atol=VAR_ATOL)


def test_drop_connect_masks_whole_samples():
    from ccvpe_tpu_torch.nn.efficientnet import apply_drop_connect, drop_connect_uniforms

    x = torch.ones(4000, 2, 3, 3)
    y = apply_drop_connect(x, 0.2, drop_connect_uniforms(x, torch.Generator().manual_seed(0)))
    per_sample = y.reshape(4000, -1)
    kept = per_sample[:, 0] > 0
    assert torch.all(per_sample[kept] == 1.0 / 0.8) and torch.all(per_sample[~kept] == 0)
    assert abs(float(kept.float().mean()) - 0.8) < 0.03
    with pytest.raises(ValueError, match="Generator"):
        drop_connect_uniforms(x, None)


def test_drop_rates_follow_block_index():
    """Rate 0.2 * i / 16 (reference model.py:262-264), applied only to the
    residual blocks and only in train mode."""
    with torch.device("meta"):
        net = EfficientNetB0()
    rates = [blk.drop_rate for blk in net._blocks]
    np.testing.assert_allclose(rates, [0.2 * i / 16 for i in range(16)])
    net = load_module(EfficientNetB0, {k: torch.zeros_like(v, device="cpu")
                                       for k, v in net.state_dict().items()})
    x = torch.zeros(1, 3, 40, 72)
    with torch.no_grad():
        net(x)                               # eval mode needs no generator
        with pytest.raises(ValueError, match="Generator"):
            net.train()(x)
