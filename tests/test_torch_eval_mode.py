"""The eval steps run the model in eval mode whatever mode it is in, as the
JAX package's apply with train=False (ccvpe_tpu/train/step.py:262, :279),
and leave the caller's mode as it was.

On tiny() on the CPU, a model in train mode (create_train_state's) through
make_eval_step, make_eval_decode_step and stream_eval's default step gives
the same bits as the same weights in eval mode; every BN buffer
(running_mean, running_var, num_batches_tracked) is bit-identical before
and after, and model.training is still True. Tolerance: none, bit
equality (the same weights, inputs and ops in one process)."""

import numpy as np
import pytest
import torch

from _torch_driver import few_threads, SyntheticDataset
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.train.step import (create_train_state, make_eval_decode_step,
                                        make_eval_step)
from ccvpe_tpu_torch.train.stream import stream_eval

pytestmark = pytest.mark.usefixtures("few_threads")

B = 2


@pytest.fixture(scope="module")
def models():
    cfg = tcfg.tiny()
    state = create_train_state(cfg, tcfg.TrainConfig(), torch.Generator().manual_seed(3),
                               device="cpu")
    assert state.model.training
    reference = build_cvm(cfg, "cpu", state_dict=state.model.state_dict())
    assert not reference.training
    return cfg, state.model, reference


def _inputs(cfg):
    rng = np.random.default_rng(11)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    return (torch.from_numpy(rng.integers(0, 256, (B, hg, wg, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (B, hs, ws, 3), dtype=np.uint8)),
            torch.from_numpy(rng.uniform(-20, 20, B).astype(np.float32)),
            torch.from_numpy(rng.uniform(-20, 20, B).astype(np.float32)))


def _buffers(model):
    return {n: b.clone() for n, b in model.named_buffers()}


def _run(name, cfg, model):
    grd, sat, rows, cols = _inputs(cfg)
    if name == "eval_step":
        return make_eval_step(model)(grd, sat)
    if name == "eval_decode_step":
        return make_eval_decode_step(model)(grd, sat, rows, cols)
    summary = stream_eval(model, cfg, SyntheticDataset(cfg, n=3), range(3), batch_size=B,
                          num_workers=1, device="cpu")
    summary.pop("fps")
    summary.pop("aggregate_fps")
    return summary


@pytest.mark.parametrize("name", ["eval_step", "eval_decode_step", "stream_eval"])
def test_eval_steps_run_in_eval_mode(models, name):
    cfg, model, reference = models
    before = _buffers(model)
    got = _run(name, cfg, model)
    want = _run(name, cfg, reference)
    if isinstance(want, dict):
        assert got == want
    else:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert model.training and not reference.training
    after = _buffers(model)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
