"""The port's entry points compute in float32 whatever the caller set.

A caller switches TF32 on in cuBLAS and cuDNN; InferenceEngine._run, the
eval decode step and one train step (forward, backward, optimizer update)
on tiny() must see both flags False inside, read from a forward hook, a
gradient hook on the first parameter (the last reached by the backward)
and an optimizer pre-step hook, and the caller's True again
after each call. The flags are process-wide, so the CPU shows what the
card would do."""

import numpy as np
import pytest
import torch

from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core.precision import float32_matmuls
from ccvpe_tpu_torch.serve import InferenceEngine
from ccvpe_tpu_torch.train.step import (Batch, create_train_state, make_eval_decode_step,
                                        make_train_step)

BATCH = 2


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    """The caller's setting: TF32 on in both; restored to what it was after the test."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture(scope="module")
def setup():
    cfg = tcfg.tiny()
    rng = np.random.default_rng(31)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    grd = rng.integers(0, 256, (BATCH, hg, wg, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (BATCH, hs, ws, 3), dtype=np.uint8)
    batch = Batch(torch.from_numpy(grd), torch.from_numpy(sat),
                  torch.from_numpy(rng.uniform(-20, 20, BATCH).astype(np.float32)),
                  torch.from_numpy(rng.uniform(-20, 20, BATCH).astype(np.float32)),
                  torch.from_numpy(rng.uniform(0, 360, BATCH).astype(np.float32)))
    return cfg, batch


def _record_forward(model, seen):
    return model.register_forward_hook(lambda *_: seen.append(("forward", _flags())))


def test_float32_matmuls_restores_the_callers_flags(tf32_on):
    with float32_matmuls():
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    torch.backends.cudnn.allow_tf32 = False
    with pytest.raises(RuntimeError):
        with float32_matmuls():
            raise RuntimeError("inside")
    assert _flags() == (True, False)


def test_inference_engine_runs_in_float32(setup, tf32_on):
    cfg, batch = setup
    state = create_train_state(cfg, tcfg.TrainConfig(), torch.Generator().manual_seed(3),
                               device="cpu")
    engine = InferenceEngine(cfg, state.model.state_dict(), batch_size=BATCH, device="cpu")
    seen = []
    handle = _record_forward(engine.model, seen)
    rows = engine._run(batch.grd.numpy(), batch.sat.numpy())[0]
    handle.remove()
    assert len(rows) == BATCH
    assert seen == [("forward", (False, False))]
    assert _flags() == (True, True)


def test_eval_decode_step_runs_in_float32(setup, tf32_on):
    cfg, batch = setup
    state = create_train_state(cfg, tcfg.TrainConfig(), torch.Generator().manual_seed(4),
                               device="cpu")
    model = state.model.eval()
    seen = []
    handle = _record_forward(model, seen)
    out = make_eval_decode_step(model)(batch.grd, batch.sat, batch.row_offset, batch.col_offset)
    handle.remove()
    assert all(v.shape == (BATCH,) for v in out)
    assert seen == [("forward", (False, False))]
    assert _flags() == (True, True)


def test_train_step_runs_in_float32(setup, tf32_on):
    """Forward, backward and the optimizer update all inside float32."""
    cfg, batch = setup
    state = create_train_state(cfg, tcfg.TrainConfig(), torch.Generator().manual_seed(5),
                               device="cpu")
    seen = []
    handles = [_record_forward(state.model, seen),
               next(state.model.parameters()).register_hook(
                   lambda _: seen.append(("backward", _flags()))),
               state.optimizer.opt.register_step_pre_hook(
                   lambda *_: seen.append(("update", _flags())))]
    state, metrics = make_train_step(cfg, tcfg.TrainConfig())(state, batch,
                                                              torch.Generator().manual_seed(6))
    for h in handles:
        h.remove()
    assert np.isfinite(float(metrics["loss"]))
    assert seen == [(k, (False, False)) for k in ("forward", "backward", "update")]
    assert _flags() == (True, True)
