"""Port vs JAX: ground descriptor head ((w, c) flatten order), aerial chunk
head ((C, ch, cw) chunk order) and l2_normalize."""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import OUT_TOL, jax_variables, load_module, nchw
from ccvpe_tpu.nn import heads as jheads
from ccvpe_tpu.utils.torch_convert import flatten
from ccvpe_tpu_torch.nn import heads as theads
from ccvpe_tpu_torch.utils.convert import grd_head_state_dict, sat_head_state_dict


def test_ground_head_matches_jax(rng):
    b, h, w, f, c = 2, 3, 5, 24, 8
    x = rng.normal(size=(b, h, w, f)).astype(np.float32)
    module = jheads.GroundDescriptorHead(c)
    variables = jax_variables(module, x, seed=3)
    ref = np.asarray(module.apply(variables, x))
    tmod = load_module(lambda: theads.GroundDescriptorHead(f, c, h),
                       grd_head_state_dict(flatten(variables["params"])))
    out = tmod(nchw(x)).detach().numpy()
    assert out.shape == (b, w * c)
    np.testing.assert_allclose(out, ref, **OUT_TOL)


def test_sat_head_matches_jax(rng):
    b, gh, gw, f, grid, d = 2, 4, 6, 16, 2, 24
    x = rng.normal(size=(b, gh, gw, f)).astype(np.float32)
    module = jheads.SatDescriptorHead(d, grid)
    variables = jax_variables(module, x, seed=4)
    ref = np.asarray(module.apply(variables, x))
    chunk = (gh // grid) * (gw // grid)
    tmod = load_module(lambda: theads.SatDescriptorHead(f, chunk, d, grid),
                       sat_head_state_dict(flatten(variables["params"])))
    out = tmod(nchw(x)).detach().numpy()
    assert out.shape == (b, grid, grid, d)
    np.testing.assert_allclose(out, ref, **OUT_TOL)


def test_l2_normalize_matches_jax(rng):
    x = rng.normal(size=(3, 4, 5, 7)).astype(np.float32)
    x[0, 0, 0] = 0.0          # the eps clamp
    for axis in (-1, 1):
        ref = np.asarray(jheads.l2_normalize(jnp.asarray(x), axis=axis))
        out = theads.l2_normalize(torch.from_numpy(x), dim=axis).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-7, rtol=1e-6)
    half = theads.l2_normalize(torch.from_numpy(x).half(), dim=-1)
    assert half.dtype == torch.float32
