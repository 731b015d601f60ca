"""ModelConfig.ori_window in the port: the windowed GT, the window origins,
and the windowed train-time ori decoder against the full field and against
the JAX package.

The window is exact because the sigma-4 Gaussian loss weight underflows to
0.0f beyond ~58 px (ccvpe_tpu/core/config.py:154-163), so the windowed
losses and gradients are the full field's; the tolerances are the JAX
suite's own (tests/test_ori_window.py:64-81): losses rtol 1e-6, gradients
atol 1e-2 / rtol 3e-4 (encoder-side sums of terms of ~1e-1..1e2 run in
another reduction order; a windowing fault shows at the gradients' own
magnitude, ~1e2..1e3). Port vs JAX: the gt test's atol 1e-6 for the GT
(the two linspaces may differ in the last bit), exact origins, and the
train-step test's loss rtol 1e-4 (tests/test_torch_train_step.py)."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccvpe_tpu.nn.efficientnet as jeff
import ccvpe_tpu_torch.nn.efficientnet as teff
from _torch_helpers import jax_variables
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.ops import gt as jgt
from ccvpe_tpu.train import step as jstep
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.ops import gt as tgt
from ccvpe_tpu_torch.train import step as tstep
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

WIN = 160
LOSS_RTOL_WINDOW = 1e-6
GRAD_ATOL_WINDOW, GRAD_RTOL_WINDOW = 1e-2, 3e-4
LOSS_RTOL_JAX = 1e-4


def test_window_equals_sliced_full_map_and_jax():
    rng = np.random.default_rng(0)
    b, h, w, win = 3, 128, 128, 48
    row = rng.uniform(-30, 30, b).astype(np.float32)
    col = rng.uniform(-30, 30, b).astype(np.float32)
    r0 = rng.integers(0, h - win, b).astype(np.int32)
    c0 = rng.integers(0, w - win, b).astype(np.int32)
    full = tgt.gaussian_heatmap(h, w, torch.from_numpy(row), torch.from_numpy(col))
    windowed = tgt.gaussian_heatmap_window(h, w, win, torch.from_numpy(r0), torch.from_numpy(c0),
                                           torch.from_numpy(row), torch.from_numpy(col))
    assert windowed.dtype == torch.float32 and windowed.shape == (b, win, win, 1)
    for i in range(b):
        assert torch.equal(windowed[i], full[i, r0[i]:r0[i] + win, c0[i]:c0[i] + win])
    ref = jgt.gaussian_heatmap_window(h, w, win, jnp.asarray(r0), jnp.asarray(c0),
                                      jnp.asarray(row), jnp.asarray(col))
    np.testing.assert_allclose(windowed.numpy(), np.asarray(ref), atol=1e-6)


def _offsets(rng, hs, ws, b, edge):
    """Offsets around the centre, or at the image's corners (the window
    clamps to the border there)."""
    if edge:
        signs = rng.choice([-1.0, 1.0], size=(2, b))
        return ((signs[0] * (hs / 2 - rng.uniform(0, 8, b))).astype(np.float32),
                (signs[1] * (ws / 2 - rng.uniform(0, 8, b))).astype(np.float32))
    return (rng.uniform(-hs / 3, hs / 3, b).astype(np.float32),
            rng.uniform(-ws / 3, ws / 3, b).astype(np.float32))


@pytest.mark.parametrize("sat,win", [(256, 160), (512, 160), (512, 224), (512, 512)])
@pytest.mark.parametrize("edge", [False, True], ids=["inside", "corners"])
def test_ori_window_starts_match_jax(sat, win, edge):
    rng = np.random.default_rng(sat + win)
    b = 64
    row, col = _offsets(rng, sat, sat, b, edge)
    zeros = np.zeros(b, np.float32)
    jb = jstep.Batch(None, None, jnp.asarray(row), jnp.asarray(col), jnp.asarray(zeros))
    tb = tstep.Batch(None, None, torch.from_numpy(row), torch.from_numpy(col),
                     torch.from_numpy(zeros))
    jr, jc = jstep.ori_window_starts(dataclasses.replace(jcfg.tiny(sat=sat), ori_window=win), jb)
    tr, tc = tstep.ori_window_starts(dataclasses.replace(tcfg.tiny(sat=sat), ori_window=win), tb)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tr % 4 == 0).all() and (tr >= 0).all() and (tr <= sat - win).all()
    if edge:      # some origins sit on the border they were clamped to
        assert bool(((tr == 0) | (tr == (sat - win) // 4 * 4)).any())


def _batch(cfg, b, edge, seed=3):
    rng = np.random.default_rng(seed)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    if edge:      # the GT near a corner: the window clamps to the border
        row = np.full(b, -(hs / 2 - 6), np.float32)
        col = np.full(b, ws / 2 - 6, np.float32)
    else:
        row = rng.uniform(-40, 40, b).astype(np.float32)
        col = rng.uniform(-40, 40, b).astype(np.float32)
    return jstep.Batch(
        grd=rng.normal(size=(b, hg, wg, 3)).astype(np.float32),
        sat=rng.normal(size=(b, hs, ws, 3)).astype(np.float32),
        row_offset=row, col_offset=col,
        angle_deg=rng.uniform(0, 360, b).astype(np.float32))


@pytest.fixture(scope="module")
def weights():
    """tiny(sat=256) JAX variables from a numpy seed and their state dict."""
    cfg = jcfg.tiny(sat=256)
    variables = jax_variables(JaxCVM(cfg), np.zeros((1, *cfg.grd_size, 3), np.float32),
                              np.zeros((1, *cfg.sat_size, 3), np.float32), False, seed=31)
    return variables, state_dict_from_jax(variables["params"], variables["batch_stats"])


def _port_losses_and_grads(sd, cfg, batch, seed=7):
    """One train-mode forward and backward from `sd`, drop-connect masks
    from a generator of `seed`: (metrics, {name: grad})."""
    state = tstep.create_train_state(cfg, tcfg.TrainConfig(), device="cpu", state_dict=sd)
    loss_fn = tstep.make_loss_fn(state.model, cfg, tcfg.TrainConfig())
    total, metrics = loss_fn(tstep.Batch(*map(torch.from_numpy, batch)),
                             torch.Generator().manual_seed(seed))
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad for n, p in state.model.named_parameters()})


@pytest.mark.parametrize("edge", [False, True], ids=["inside", "corner"])
def test_windowed_losses_and_grads_match_full(weights, edge):
    """The port's windowed step against its own full-field step on the same
    weights, batch and drop-connect masks."""
    _, sd = weights
    base = tcfg.tiny(sat=256)
    batch = _batch(base, 2, edge)
    m_full, g_full = _port_losses_and_grads(sd, base, batch)
    m_win, g_win = _port_losses_and_grads(sd, dataclasses.replace(base, ori_window=WIN), batch)
    np.testing.assert_allclose(m_win["loss"], m_full["loss"], rtol=LOSS_RTOL_WINDOW)
    np.testing.assert_allclose(m_win["loss_ori"], m_full["loss_ori"], rtol=LOSS_RTOL_WINDOW)
    assert g_win.keys() == g_full.keys()
    for name, g in g_full.items():
        np.testing.assert_allclose(g_win[name].numpy(), g.numpy(), atol=GRAD_ATOL_WINDOW,
                                   rtol=GRAD_RTOL_WINDOW, err_msg=name)


def test_windowed_forward_crops_the_field(weights):
    """The windowed ori field is the full field's window where the two
    finest stages see no border (3x3 convs read zero padding at a crop's
    edge, not the neighbours): its interior within float32 roundoff."""
    from ccvpe_tpu_torch.models.cvm import build_cvm
    _, sd = weights
    cfg = dataclasses.replace(tcfg.tiny(sat=256), ori_window=WIN)
    model = build_cvm(cfg, "cpu", state_dict=sd)
    batch = _batch(cfg, 2, False)
    g, s = torch.from_numpy(batch.grd), torch.from_numpy(batch.sat)
    r0, c0 = tstep.ori_window_starts(cfg, tstep.Batch(*map(torch.from_numpy, batch)))
    with torch.no_grad():
        full = model(g, s)
        win = model(g, s, ori_window=(r0, c0))
    assert full.ori_offsets is None and win.ori.shape == (2, WIN, WIN, 2)
    assert torch.equal(win.ori_offsets, torch.stack([r0, c0], -1))
    assert torch.equal(win.logits, full.logits)          # the loc branch never windows
    ring = 8       # the receptive field of the two finest stages' convs
    for i in range(2):
        crop = full.ori[i, r0[i]:r0[i] + WIN, c0[i]:c0[i] + WIN]
        np.testing.assert_allclose(win.ori[i, ring:-ring, ring:-ring].numpy(),
                                   crop[ring:-ring, ring:-ring].numpy(), atol=1e-5)


def test_windowed_loss_matches_jax(weights):
    """The port's windowed losses against the JAX package's windowed
    make_loss_fn on the same weights and batch, drop-connect off in both
    (the RNG streams cannot be aligned)."""
    variables, sd = weights
    jax_cfg = dataclasses.replace(jcfg.tiny(sat=256), ori_window=WIN)
    port_cfg = dataclasses.replace(tcfg.tiny(sat=256), ori_window=WIN)
    batch = _batch(port_cfg, 2, False, seed=4)
    with mock.patch.object(jeff, "DROP_CONNECT_RATE", 0.0):
        loss_fn = jstep.make_loss_fn(JaxCVM(jax_cfg), jax_cfg, jcfg.TrainConfig())
        _, (_, ref) = jax.jit(loss_fn)(variables["params"], variables["batch_stats"],
                                       jstep.Batch(*map(jnp.asarray, batch)),
                                       jax.random.PRNGKey(0))
    with mock.patch.object(teff, "DROP_CONNECT_RATE", 0.0):
        got, _ = _port_losses_and_grads(sd, port_cfg, batch)
    for k, want in ref.items():
        np.testing.assert_allclose(got[k], float(want), rtol=LOSS_RTOL_JAX, err_msg=k)
