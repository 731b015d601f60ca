"""Shared helpers of the port's parity tests (tests/test_torch_*.py): JAX
variables filled from a numpy seed, carried into torch modules."""

import jax
import numpy as np
import pytest
import torch

from ccvpe_tpu.utils.torch_convert import flatten, unflatten

# Tolerances of the JAX suite's own comparisons with torch
# (tests/test_model_parity.py:48-57, tests/test_corr_pallas.py:34-35).
CORR_TOL = dict(atol=5e-5, rtol=1e-4)
OUT_TOL = dict(atol=5e-4, rtol=1e-3)
HEATMAP_ATOL = 1e-6
# Where the port's heatmap argmax differs from the JAX one, the two JAX
# heatmap values there must lie within TIE_ATOL of each other: a tie of the
# random model, not a port fault. The tiny() forwards of the two packages
# agree to ~4e-11 on the CPU, and the eval tests' inputs hold top-2 gaps of
# 2e-8 and more, so 1e-9 tells a tie from a wrong decode (HEATMAP_ATOL is
# ten times the heatmap's own top-2 gaps and would not).
TIE_ATOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for a module's tests (imported by the
    modules that use it): tiny() steps run as fast on one thread, and the
    suite's parallel workers share the machine's cores, where spinning
    thread pools of every worker slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fill_variables(shapes, seed: int):
    """Numpy values for an eval_shape tree of flax variables: kernels
    ~ N(0, 1/fan_in), biases ~ N(0, 0.1), BN scale ~ U(0.5, 1.5),
    BN mean ~ N(0, 0.1), BN var ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for path, leaf in sorted(flatten(tree).items()):
            shape, name = tuple(leaf.shape), path[-1]
            if col == "batch_stats":
                v = (rng.normal(0, 0.1, shape) if name == "mean"
                     else rng.uniform(0.5, 1.5, shape))
            elif name == "scale":
                v = rng.uniform(0.5, 1.5, shape)
            elif name in ("bias", "h_bias"):
                v = rng.normal(0, 0.1, shape)
            else:
                fan_in = shape[-1] if name == "h_weight" else int(np.prod(shape[:-1]))
                v = rng.normal(0, fan_in ** -0.5, shape)
            flat[path] = v.astype(np.float32)
        out[col] = unflatten(flat)
    return out


def jax_variables(module, *args, seed: int = 0):
    """Shapes from eval_shape (no eager init), values from fill_variables."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return fill_variables(shapes, seed)


def load_module(factory, state_dict):
    """Build a port module on the meta device, then load `state_dict` strictly."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device="cpu")
    module.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()},
                           strict=True)
    return module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()



def same_peaks(got_rows, got_cols, want_rows, want_cols, jax_heatmap):
    """Mask of the samples whose port argmax is the JAX one. Every other
    sample must be a tie (TIE_ATOL) of its JAX heatmap, `jax_heatmap(idx)`
    giving those of the samples `idx` as [k, H, W]; and at most one sample
    may differ, so the comparisons that follow cover all but one."""
    got_rows, got_cols, want_rows, want_cols = map(
        np.asarray, (got_rows, got_cols, want_rows, want_cols))
    same = (got_rows == want_rows) & (got_cols == want_cols)
    idx = np.flatnonzero(~same)
    assert len(idx) <= 1, f"samples {idx.tolist()} decode to other peaks"
    if len(idx):
        heat = np.asarray(jax_heatmap(idx))
        for j, i in enumerate(idx):
            gap = abs(float(heat[j, got_rows[i], got_cols[i]])
                      - float(heat[j, want_rows[i], want_cols[i]]))
            assert gap < TIE_ATOL, (int(i), gap)
    return same
