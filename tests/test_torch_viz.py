"""utils/viz.py::render_qualitative of the port against the JAX package's
on the same arrays: the PNGs each writes decode to the same pixels (no
tolerance), with and without the angle in the title and at two quiver
steps."""

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
pytest.importorskip("matplotlib")
import PIL.Image  # noqa: E402

from ccvpe_tpu.utils.viz import render_qualitative as jax_render  # noqa: E402
from ccvpe_tpu_torch.utils.viz import render_qualitative  # noqa: E402


@pytest.mark.parametrize("angle, step", [(123.4, 40), (None, 16)], ids=["angle", "no angle"])
def test_png_pixels_equal_the_jax_package(tmp_path, angle, step):
    rng = np.random.default_rng(9)
    hs, ws = 96, 80
    heat = rng.uniform(1e-6, 1.0, (hs, ws)).astype(np.float32)
    heat /= heat.sum()
    ori = rng.normal(size=(hs, ws, 2)).astype(np.float32)
    ori /= np.linalg.norm(ori, axis=-1, keepdims=True)
    args = (rng.uniform(size=(32, 64, 3)), rng.uniform(size=(hs, ws, 3)), heat, ori,
            (40.5, 30.0), (12, 70))
    paths = [str(tmp_path / f"{name}.png") for name in ("port", "jax")]
    assert render_qualitative(*args, paths[0], angle_deg=angle, quiver_step=step) == paths[0]
    jax_render(*args, paths[1], angle_deg=angle, quiver_step=step)
    port, ref = (np.asarray(PIL.Image.open(p)) for p in paths)
    assert port.shape == ref.shape and port.shape[0] > 100
    np.testing.assert_array_equal(port, ref)
