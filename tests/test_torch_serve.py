"""Port vs JAX: InferenceEngine.predict with a padded tail, the scalar eval
step, pose decoding; and the port's refusals (no card, 'cuda' on CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import HEATMAP_ATOL, jax_variables, same_peaks
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.ops import pose as jpose
from ccvpe_tpu.serve import InferenceEngine as JaxEngine
from ccvpe_tpu.train.step import device_normalize as jax_normalize
from ccvpe_tpu.train.step import make_eval_decode_step as jax_eval_step
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.ops import pose as tpose
from ccvpe_tpu_torch.serve import InferenceEngine, resolve_device
from ccvpe_tpu_torch.train.step import device_normalize, make_eval_decode_step
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

N_REQ, BATCH = 5, 4


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny()
    model = JaxCVM(cfg)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    rng = np.random.default_rng(21)
    grd = rng.integers(0, 256, (N_REQ, hg, wg, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (N_REQ, hs, ws, 3), dtype=np.uint8)
    variables = jax_variables(model, np.zeros((1, hg, wg, 3), np.float32),
                              np.zeros((1, hs, ws, 3), np.float32), False, seed=22)
    heatmap = jax.jit(lambda v, g, s: model.apply(
        v, jax_normalize(g), jax_normalize(s), False).heatmap)(variables, grd, sat)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return dict(cfg=cfg, model=model, variables=variables, grd=grd, sat=sat,
                heatmap=np.asarray(heatmap)[..., 0], state_dict=sd)


def assert_same_peak(heatmap, rows, cols, ref_rows, ref_cols):
    """Equal argmax, except at one near-tie where the two JAX heatmap
    values differ by less than TIE_ATOL (_torch_helpers.same_peaks)."""
    same_peaks(rows, cols, ref_rows, ref_cols, lambda idx: heatmap[idx])


def test_predict_matches_jax_with_padded_tail(setup):
    ref = JaxEngine(setup["cfg"], setup["variables"]["params"],
                    setup["variables"]["batch_stats"], batch_size=BATCH
                    ).predict(setup["grd"], setup["sat"])
    port = InferenceEngine(tcfg.tiny(), setup["state_dict"], batch_size=BATCH,
                           device="cpu")
    out = port.predict(setup["grd"], setup["sat"])
    assert len(out) == len(ref) == N_REQ
    assert_same_peak(setup["heatmap"], [p.row for p in out], [p.col for p in out],
                     [p.row for p in ref], [p.col for p in ref])
    for p, q in zip(out, ref):
        if (p.row, p.col) == (q.row, q.col):
            np.testing.assert_allclose(p.angle_deg, q.angle_deg, atol=1e-2)
            np.testing.assert_allclose(p.probability, q.probability, atol=HEATMAP_ATOL)
    # the padded tail gives what an unpadded run of the same requests gives
    again = port.predict(setup["grd"][BATCH:], setup["sat"][BATCH:])
    assert [(p.row, p.col) for p in again] == [(p.row, p.col) for p in out[BATCH:]]


def _offsets_off_ties(rng, size, n, sign):
    """Offsets a quarter grid step from a grid point, never at a midpoint."""
    grid = np.linspace(-size / 2.0, size / 2.0, size)
    idx = rng.integers(0, size, n)
    step = grid[1] - grid[0]
    return (sign * (grid[idx] + rng.uniform(-0.25, 0.25, n) * step)).astype(np.float32)


def test_eval_decode_step_matches_jax(setup):
    hs, ws = setup["cfg"].sat_size
    rng = np.random.default_rng(23)
    row_off = _offsets_off_ties(rng, hs, N_REQ, 1.0)
    col_off = _offsets_off_ties(rng, ws, N_REQ, -1.0)
    ref = jax_eval_step(setup["model"], setup["cfg"])(
        setup["variables"]["params"], setup["variables"]["batch_stats"],
        setup["grd"], setup["sat"], row_off, col_off)
    ref = [np.asarray(v) for v in ref]
    model = build_cvm(tcfg.tiny(), "cpu", state_dict=setup["state_dict"])
    out = make_eval_decode_step(model)(
        torch.from_numpy(setup["grd"]), torch.from_numpy(setup["sat"]),
        torch.from_numpy(row_off), torch.from_numpy(col_off))
    out = [v.numpy() for v in out]
    assert all(v.shape == (N_REQ,) for v in out)
    assert_same_peak(setup["heatmap"], out[0], out[1], ref[0], ref[1])
    same = (out[0] == ref[0]) & (out[1] == ref[1])
    np.testing.assert_allclose(out[2][same], ref[2][same], atol=1e-2)
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_array_equal(out[4], ref[4])
    np.testing.assert_array_equal(out[3], jpose.gt_location(hs, ws, row_off, col_off)[0])
    np.testing.assert_allclose(out[5], ref[5], atol=HEATMAP_ATOL)


def test_device_normalize_matches_jax(setup):
    g = setup["grd"][:2]
    ref = np.asarray(jax_normalize(jnp.asarray(g)))
    out = device_normalize(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    f = ref.astype(np.float32)
    np.testing.assert_array_equal(device_normalize(torch.from_numpy(f)).numpy(), f)


def test_decode_pose_matches_jax(rng):
    heat = rng.uniform(size=(6, 5, 7, 1)).astype(np.float32)
    heat[0, 1, 2, 0] = heat[0, 3, 4, 0] = 2.0       # tie: the first maximum wins
    ori = rng.normal(size=(6, 5, 7, 2)).astype(np.float32)
    ori /= np.linalg.norm(ori, axis=-1, keepdims=True)
    ref = [np.asarray(v) for v in jpose.decode_pose(jnp.asarray(heat), jnp.asarray(ori))]
    out = [v.numpy() for v in tpose.decode_pose(torch.from_numpy(heat), torch.from_numpy(ori))]
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[2], ref[2], atol=1e-3)
    cos = np.array([1.0, -1.0, 0.0, 0.5, 0.5, -0.2], np.float32)
    sin = np.array([0.0, -1e-7, -1.0, -0.8, 0.8, -0.9], np.float32)
    np.testing.assert_allclose(
        tpose.decode_angle(torch.from_numpy(cos), torch.from_numpy(sin)).numpy(),
        np.asarray(jpose.decode_angle(jnp.asarray(cos), jnp.asarray(sin))), atol=1e-3)


def test_host_metrics_match_jax(rng):
    n, hs, ws = 9, 64, 48
    rows, cols = rng.integers(0, hs, n), rng.integers(0, ws, n)
    row_off, col_off = rng.uniform(-hs / 2, hs / 2, n), rng.uniform(-ws / 2, ws / 2, n)
    pred, gt = rng.uniform(0, 360, n), rng.uniform(0, 360, n)
    for a, b in zip(tpose.gt_location(hs, ws, row_off, col_off),
                    jpose.gt_location(hs, ws, row_off, col_off)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpose.angle_error(pred, gt), jpose.angle_error(pred, gt))
    gt_r, gt_c = jpose.gt_location(hs, ws, row_off, col_off)
    args = (rows, cols, gt_r, gt_c, gt, 0.1)
    for a, b in zip(tpose.longitudinal_lateral(*args), jpose.longitudinal_lateral(*args)):
        np.testing.assert_array_equal(a, b)
    dist = rng.uniform(0, 10, n)
    assert tpose.summarize(dist, pred, gt / 360) == jpose.summarize(dist, pred, gt / 360)
    assert tpose.summarize(dist) == jpose.summarize(dist)
    assert tpose.recalls(dist) == jpose.recalls(dist)


def test_from_checkpoint_npz_and_orbax_dir(setup, tmp_path):
    path = str(tmp_path / "cvm.npz")
    np.savez(path, **{k: v.numpy() for k, v in setup["state_dict"].items()})
    eng = InferenceEngine.from_checkpoint(tcfg.tiny(), path, batch_size=2, device="cpu")
    for k, v in eng.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), setup["state_dict"][k].numpy())
    with pytest.raises(ValueError, match="export_cvm"):
        InferenceEngine.from_checkpoint(tcfg.tiny(), str(tmp_path), device="cpu")


def test_entry_points_refuse_cpu_fallback(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; device=None would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tcfg.tiny(), setup["state_dict"], batch_size=2)


def test_corr_impl_cuda_on_cpu_raises(setup):
    cfg = dataclasses.replace(tcfg.tiny(), corr_impl="cuda")
    model = build_cvm(cfg, "cpu", state_dict=setup["state_dict"])
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    with pytest.raises(ValueError, match="CUDA tensor"), torch.inference_mode():
        model(torch.zeros(1, hg, wg, 3), torch.zeros(1, hs, ws, 3))
