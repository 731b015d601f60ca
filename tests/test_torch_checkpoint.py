"""The port's CheckpointManager (core/checkpoint.py), the four cases of
tests/test_checkpoint.py on a small torch state, and what the port adds:
the atomic-rename file layout, a failed write raised by wait(), and
train/evaluate.py::load_model reading a checkpoint directory.

Tolerance: none; every restored tensor and number equals the saved one to
the bit (torch.save and torch.load move bytes)."""

import os

import pytest
import torch
import torch.nn as nn

from ccvpe_tpu_torch.core import checkpoint as ckpt_lib
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core.checkpoint import CheckpointManager
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.train.evaluate import load_model
from ccvpe_tpu_torch.train.step import TrainState, make_optimizer

TRAIN_CFG = tcfg.TrainConfig(learning_rate=1e-2, schedule="warmup_cosine", warmup_steps=2,
                             total_steps=10)


def make_state(seed: int, steps: int = 2) -> TrainState:
    """A Linear + BatchNorm model after `steps` Adam updates on a
    warmup-cosine schedule: moments, step counts, a schedule-set learning
    rate and moved BN running stats are all in the state."""
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1d(3))
    opt = make_optimizer(model.parameters(), TRAIN_CFG)
    x = torch.randn(5, 4)
    for _ in range(steps):
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()
    return TrainState(steps, model, opt)


def assert_same_state(got: TrainState, want: TrainState):
    assert got.step == want.step
    assert got.optimizer.count == want.optimizer.count
    for (k, a), (k2, b) in zip(got.model.state_dict().items(), want.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    ga, wa = got.optimizer.opt.state_dict(), want.optimizer.opt.state_dict()
    assert ga["param_groups"] == wa["param_groups"]
    assert ga["state"].keys() == wa["state"].keys()
    for i in wa["state"]:
        for k, v in wa["state"][i].items():
            assert torch.equal(ga["state"][i][k], v), (i, k)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    state = make_state(1)
    mgr.save(7, state, cursor={"epoch": 2, "batch": 13})
    mgr.wait()

    fresh = make_state(5, steps=0)
    restored, cursor = mgr.restore_latest(fresh)
    assert restored is fresh
    assert cursor == {"epoch": 2, "batch": 13}
    assert_same_state(restored, state)
    # the restored optimizer goes on as the saved one does
    x = torch.randn(5, 4)
    for s in (restored, state):
        s.optimizer.zero_grad()
        s.model(x).square().sum().backward()
        s.optimizer.step()
    assert_same_state(restored, state)


def test_retention_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    states = {step: make_state(step) for step in (1, 2, 3)}
    for step, state in states.items():
        mgr.save(step, state)
    assert mgr.latest_step() == 3
    assert ckpt_lib.saved_steps(str(tmp_path / "ckpt")) == [2, 3]
    restored, cursor = mgr.restore_latest(make_state(9, steps=0))
    assert cursor == {"epoch": 0, "batch": 0}
    assert_same_state(restored, states[3])


def test_restore_empty_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None
    assert mgr.restore_latest(make_state(0, steps=0)) is None


def test_file_layout_is_atomic_rename(tmp_path, monkeypatch):
    """Each step is written under a hidden temporary name, then renamed into
    place: only complete step_<step:08d>.pt files are ever listed, and no
    temporary file is left behind. A save at the newest step replaces it."""
    directory = str(tmp_path / "ckpt")
    mgr = CheckpointManager(directory, keep=3)
    renames = []
    real_replace = os.replace

    def replace(src, dst):
        assert os.path.basename(src).startswith(".") and src.endswith(".tmp")
        assert os.path.exists(src) and ckpt_lib.saved_steps(directory) == sorted(renames)
        renames.append(int(os.path.basename(dst)[5:13]))
        real_replace(src, dst)

    monkeypatch.setattr(ckpt_lib.os, "replace", replace)
    mgr.save(12, make_state(1), cursor={"epoch": 0, "batch": 3})
    mgr.save(12, make_state(2), cursor={"epoch": 1, "batch": 0})
    mgr.wait()
    assert sorted(os.listdir(directory)) == ["step_00000012.pt"]
    assert renames == [12, 12]
    _, cursor = mgr.restore_latest(make_state(3, steps=0))
    assert cursor == {"epoch": 1, "batch": 0}
    assert [t["step"] for t in mgr.timings] == [12, 12]


def test_failed_write_raises_in_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))

    def broken_save(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib.torch, "save", broken_save)
    mgr.save(1, make_state(1))              # returns; the write fails behind it
    with pytest.raises(RuntimeError, match="checkpoint write") as info:
        mgr.wait()
    assert isinstance(info.value.__cause__, OSError)
    mgr.wait()                              # raised once, then cleared
    assert mgr.latest_step() is None


def test_load_model_reads_a_checkpoint_directory(tmp_path):
    """train/evaluate.py::load_model takes the newest step's model from a
    Trainer checkpoint directory; a directory without step files (an Orbax
    run) still raises."""
    cfg = tcfg.tiny()
    model = build_cvm(cfg, "cpu", generator=torch.Generator().manual_seed(4)).train()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, TrainState(3, model, make_optimizer(model.parameters(), tcfg.TrainConfig())))
    mgr.wait()
    loaded = load_model(cfg, str(tmp_path / "ckpt"), "cpu")
    assert not loaded.training
    for (k, a), (_, b) in zip(loaded.state_dict().items(), model.state_dict().items()):
        assert torch.equal(a, b), k
    os.makedirs(tmp_path / "orbax" / "0")
    with pytest.raises(ValueError, match="Orbax"):
        load_model(cfg, str(tmp_path / "orbax"), "cpu")
