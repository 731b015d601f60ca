"""Port vs JAX: on-device GT rendering (ops/gt.py) and the training losses
(train/losses.py), on the same numpy inputs. Tolerances: 1e-6 absolute on
the [0, 1] GT maps (float32 linspace grids), rtol 1e-5 on the losses
(float32 reductions in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvpe_tpu.ops import gt as jgt
from ccvpe_tpu.train import losses as jlosses
from ccvpe_tpu_torch.ops import gt as tgt
from ccvpe_tpu_torch.train import losses as tlosses


@pytest.mark.parametrize("height,width", [(128, 128), (64, 96)])
def test_gaussian_heatmap_matches_jax(height, width):
    rows = np.array([0.0, 37.0, -200.0, 12.5], np.float32)
    cols = np.array([0.0, -81.0, 150.0, -3.25], np.float32)
    ref = np.asarray(jgt.gaussian_heatmap(height, width, jnp.asarray(rows), jnp.asarray(cols)))
    out = tgt.gaussian_heatmap(height, width, torch.from_numpy(rows), torch.from_numpy(cols))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


ANGLES = np.array([0.0, 9.0, 17.999, 18.0, 90.5, 180.0, 351.0, 359.9], np.float32)


@pytest.mark.parametrize("num_bins,reversed_order", [(20, True), (20, False), (16, True)],
                         ids=["vigor_reversed", "oxford_forward", "kitti_reversed"])
def test_orientation_bin_weights_match_jax(num_bins, reversed_order):
    ref = np.asarray(jgt.orientation_bin_weights(jnp.asarray(ANGLES), num_bins, reversed_order))
    out = tgt.orientation_bin_weights(torch.from_numpy(ANGLES), num_bins, reversed_order)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_render_gt_matches_jax():
    args = (np.array([5.0, -30.0], np.float32), np.array([-3.0, 44.0], np.float32),
            np.array([45.0, 300.0], np.float32))
    ref = jgt.render_gt(64, 48, 20, *(jnp.asarray(a) for a in args))
    out = tgt.render_gt(64, 48, 20, *(torch.from_numpy(a) for a in args))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_maxpool_pyramid_matches_jax(rng):
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jgt.maxpool_pyramid(jnp.asarray(x), (2, 8, 64))
    out = tgt.maxpool_pyramid(torch.from_numpy(x), (2, 8, 64))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("global_negatives", [False, True], ids=["per_sample", "global"])
def test_infonce_matches_jax(rng, global_negatives):
    scores = rng.uniform(-1, 1, size=(4, 20 * 8 * 8)).astype(np.float32)
    labels = (rng.uniform(0, 1, size=(4, 20 * 8 * 8)) ** 8).astype(np.float32)
    ref = float(jlosses.infonce_loss(jnp.asarray(scores), jnp.asarray(labels), 0.1,
                                     global_negatives=global_negatives))
    out = float(tlosses.infonce_loss(torch.from_numpy(scores), torch.from_numpy(labels), 0.1,
                                     global_negatives=global_negatives))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_global_negatives_differ_from_per_sample(rng):
    """The two denominators are different losses (pooled is harder)."""
    scores = torch.from_numpy(rng.uniform(-1, 1, size=(3, 64)).astype(np.float32))
    labels = torch.from_numpy((rng.uniform(0, 1, size=(3, 64)) ** 4).astype(np.float32))
    per = float(tlosses.infonce_loss(scores, labels))
    pooled = float(tlosses.infonce_loss(scores, labels, global_negatives=True))
    assert pooled > per


def test_cross_entropy_matches_jax(rng):
    logits = rng.normal(size=(3, 100)).astype(np.float32)
    labels = rng.uniform(0, 1, size=(3, 100)).astype(np.float32)
    labels /= labels.sum(axis=1, keepdims=True)
    ref = float(jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    out = float(tlosses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_orientation_loss_matches_jax(rng):
    ori = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    gt_ori = rng.normal(size=(2, 16, 16, 2)).astype(np.float32)
    gt = rng.uniform(0, 1, size=(2, 16, 16, 1)).astype(np.float32)
    ref = float(jlosses.orientation_loss(*(jnp.asarray(a) for a in (ori, gt_ori, gt))))
    out = float(tlosses.orientation_loss(*(torch.from_numpy(a) for a in (ori, gt_ori, gt))))
    np.testing.assert_allclose(out, ref, rtol=1e-5)
