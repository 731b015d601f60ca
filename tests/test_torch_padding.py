"""Port vs JAX: static-224 SAME pad tables, backbone output sizes, and
SAME/circular padding (ccvpe_tpu_torch/ops/padding.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvpe_tpu.ops import padding as jpad
from ccvpe_tpu_torch.ops import padding as tpad

GEOMETRIES = [((320, 640), (10, 20)),    # VIGOR ground
              ((512, 512), (16, 16)),    # aerial
              ((154, 231), (4, 7)),      # Oxford ground
              ((256, 1024), (8, 32))]    # KITTI ground


def test_same_pad_1d_matches_jax():
    for size in range(1, 70):
        for k in (1, 3, 5, 7):
            for s in (1, 2, 3):
                assert tpad.same_pad_1d(size, k, s) == jpad.same_pad_1d(size, k, s)


@pytest.mark.parametrize("image", [(224, 224), (320, 640), (154, 231), (97, 61)])
def test_traced_same_pads_match_jax(image):
    assert tpad.traced_same_pads(image) == jpad.traced_same_pads(image)


@pytest.mark.parametrize("size,expected", GEOMETRIES)
def test_b0_output_size(size, expected):
    assert tpad.b0_output_size(size) == expected
    assert jpad.b0_output_size(size) == expected
    assert tpad.b0_layer_sizes(size)[-1] == expected


@pytest.mark.parametrize("circular", [False, True])
@pytest.mark.parametrize("pads", [((0, 1), (0, 1)), ((1, 1), (2, 2)),
                                  ((2, 2), (0, 0)), ((0, 0), (1, 2))])
def test_pad_same_matches_jax(circular, pads, rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jpad.pad_same(jnp.asarray(x), *pads, circular=circular))
    out = tpad.pad_same(torch.from_numpy(x).permute(0, 3, 1, 2), *pads, circular=circular)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)
