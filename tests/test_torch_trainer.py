"""The port's Trainer (train/trainer.py) on tiny() on the CPU.

- fit for 2 epochs of 2 batches equals the same batches fed by hand through
  make_train_step (drop-connect on, each step's generator seeded by
  step_seed) and then eval_over_loader with make_eval_decode_step: every
  parameter, BN buffer and optimizer moment, and the validation rows. Those
  two are held to JAX in test_torch_train_step.py and test_torch_evaluate.py.
- a run killed by fake_fail_at_step and resumed from its checkpoint equals
  an uninterrupted one (JAX's test_exact_midepoch_resume_matches_uninterrupted),
  log rows included (apart from time and pairs/s).
- a dict of two validation sets writes both sets' rows every epoch.
- a checkpoint under the workdir wins over warm_start; without one, the
  warm start and the pretrained backbone fill the weights.
- Trainer() takes the card by default and raises without one; a loader
  that is not this process's shard (num_shards other than the world size)
  is refused. Training across processes is
  tests/test_torch_distributed_driver.py.

Tolerance: none, bit equality (the same ops on the same inputs in one
process)."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_driver import few_threads, SyntheticDataset, train_loaders, val_loaders
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.data.loader import ThreadedLoader
from ccvpe_tpu_torch.train.evaluate import eval_over_loader
from ccvpe_tpu_torch.train.step import (create_train_state, make_eval_decode_step,
                                        make_train_step)
from ccvpe_tpu_torch.train.trainer import Trainer, batch_from_numpy, step_seed

pytestmark = pytest.mark.usefixtures("few_threads")

BATCH, EPOCHS = 4, 2
MPP = 0.1


def mpp(city):
    return MPP


@pytest.fixture(scope="module")
def data():
    cfg = tcfg.tiny()
    return cfg, SyntheticDataset(cfg, n=2 * BATCH), SyntheticDataset(cfg, n=6, seed=100)


def train_cfg(**over):
    return tcfg.TrainConfig(**{**dict(batch_size=BATCH, epochs=EPOCHS, log_every=1,
                                      keep_checkpoints=2), **over})


def fit(data, workdir, **over):
    cfg, train_set, val_set = data
    trainer = Trainer(cfg, train_cfg(**over), workdir=str(workdir), device="cpu")
    trainer.fit(train_loaders(train_set, BATCH), val_loaders(val_set, BATCH), mpp)
    return trainer


def rows(workdir, name="tiny"):
    """The JSONL rows without their wall-clock fields."""
    with open(os.path.join(workdir, f"{name}.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "pairs_per_s")}
                for line in f]


def assert_same_training(got, want):
    assert got.step == want.step
    assert got.optimizer.count == want.optimizer.count
    for (k, a), (k2, b) in zip(got.model.state_dict().items(), want.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    ga, wa = got.optimizer.opt.state_dict(), want.optimizer.opt.state_dict()
    assert ga["param_groups"] == wa["param_groups"]
    for i, s in wa["state"].items():
        for k, v in s.items():
            assert torch.equal(ga["state"][i][k], v), (i, k)


@pytest.fixture(scope="module")
def control(data, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("control")
    return fit(data, workdir), str(workdir)


def test_fit_equals_steps_by_hand(data, control):
    trainer, workdir = control
    cfg, train_set, val_set = data
    tc = train_cfg()
    state = create_train_state(cfg, tc, torch.Generator().manual_seed(tc.seed), device="cpu")
    step = make_train_step(cfg, tc)
    gen = torch.Generator()
    want_rows = []
    for epoch in range(EPOCHS):
        for raw in train_loaders(train_set, BATCH)(epoch):
            gen.manual_seed(step_seed(tc.seed, state.step))
            state, m = step(state, batch_from_numpy(raw), gen)
            want_rows.append({"step": state.step, **{k: float(v) for k, v in m.items()}})
        summary = eval_over_loader(make_eval_decode_step(state.model),
                                   val_loaders(val_set, BATCH)(epoch), mpp, device="cpu")
        want_rows.append({"step": state.step, **{f"val/{k}": v for k, v in summary.items()}})
    assert state.step == EPOCHS * 2
    assert_same_training(trainer.state, state)
    assert rows(workdir) == want_rows
    assert trainer.ckpt.latest_step() == state.step


def test_resume_after_fault_equals_uninterrupted(data, control, tmp_path):
    want, control_dir = control
    with pytest.raises(RuntimeError, match="fake failure"):
        fit(data, tmp_path, checkpoint_every_steps=1, fake_fail_at_step=3)
    cfg, train_set, val_set = data
    # restart: resumes at epoch 1, batch 1 (the failure hit batch 0 of epoch
    # 1), replaying nothing and skipping nothing
    resumed = Trainer(cfg, train_cfg(), workdir=str(tmp_path), device="cpu")
    assert resumed.restored and resumed.state.step == 3
    assert resumed.cursor == {"epoch": 1, "batch": 1}
    resumed.fit(train_loaders(train_set, BATCH), val_loaders(val_set, BATCH), mpp)
    assert_same_training(resumed.state, want.state)
    # step 3's own row was never written: the failure came before it
    control_rows = rows(control_dir)
    assert rows(str(tmp_path)) == [r for r in control_rows if r["step"] != 3 or len(r) > 5]


def test_two_validation_sets(data, tmp_path):
    cfg, train_set, val_set = data
    trainer = Trainer(cfg, train_cfg(epochs=1, log_every=10), workdir=str(tmp_path),
                      device="cpu")
    loaders = val_loaders(val_set, BATCH)
    trainer.fit(train_loaders(train_set, BATCH),
                lambda epoch: {"test1": loaders(epoch), "test2": loaders(epoch)}, mpp)
    got = rows(str(tmp_path))
    assert len(got) == 2                       # no loss row: log_every > steps
    test1 = {k[6:]: v for k, v in got[0].items() if k.startswith("test1/")}
    test2 = {k[6:]: v for k, v in got[1].items() if k.startswith("test2/")}
    assert test1 == test2
    for metric in ("median_distance_m", "long_recall@1", "lat_recall@5", "ori_recall@1deg"):
        assert metric in test1


def _state_dict_file(path, seed, cfg):
    from ccvpe_tpu_torch.models.cvm import build_cvm
    sd = build_cvm(cfg, "cpu", generator=torch.Generator().manual_seed(seed)).state_dict()
    torch.save(sd, path)
    return sd


def test_restore_wins_over_warm_start(data, tmp_path):
    cfg = data[0]
    warm = _state_dict_file(str(tmp_path / "warm.pt"), 123, cfg)
    started = Trainer(cfg, train_cfg(warm_start=str(tmp_path / "warm.pt")),
                      workdir=str(tmp_path / "run"), device="cpu")
    assert not started.restored
    for k, v in warm.items():
        assert torch.equal(started.state.model.state_dict()[k], v), k
    # a checkpoint of other weights, then the same warm start again
    other = Trainer(cfg, train_cfg(seed=5), workdir=str(tmp_path / "other"), device="cpu")
    other.state.step = 9
    started.ckpt.save(9, other.state, cursor={"epoch": 3, "batch": 1})
    started.ckpt.wait()
    again = Trainer(cfg, train_cfg(warm_start=str(tmp_path / "warm.pt")),
                    workdir=str(tmp_path / "run"), device="cpu")
    assert again.restored and again.state.step == 9
    assert again.cursor == {"epoch": 3, "batch": 1}
    assert_same_training(again.state, other.state)


def test_pretrained_backbone_fills_both_encoders(data, tmp_path):
    cfg = data[0]
    rng = np.random.default_rng(2)
    fresh = Trainer(cfg, train_cfg(), workdir=str(tmp_path / "a"), device="cpu")
    enc = fresh.state.model.grd_efficientnet.state_dict()
    backbone = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in enc.items()
                if not k.endswith("num_batches_tracked")}
    backbone["_fc.weight"] = rng.normal(size=(1000, 1280)).astype(np.float32)
    np.savez(tmp_path / "b0.npz", **backbone)
    trainer = Trainer(cfg, train_cfg(pretrained_backbone=str(tmp_path / "b0.npz")),
                      workdir=str(tmp_path / "b"), device="cpu")
    model = trainer.state.model
    for encoder in (model.grd_efficientnet, model.sat_efficientnet):
        sd = encoder.state_dict()
        for k, v in backbone.items():
            if not k.startswith("_fc."):
                assert np.array_equal(sd[k].numpy(), v), k
    for k, v in fresh.state.model.conv1.state_dict().items():
        assert torch.equal(model.conv1.state_dict()[k], v), k


def test_trainer_defaults_to_the_card(data, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(data[0], train_cfg(), workdir=str(tmp_path))


def test_sharded_loader_is_refused(data, tmp_path):
    cfg, train_set, _ = data
    trainer = Trainer(cfg, train_cfg(), workdir=str(tmp_path), device="cpu")
    loader = ThreadedLoader(train_set, BATCH // 2, num_shards=2, shard_id=0)
    with pytest.raises(ValueError, match="shard 0 of 2: this is process 0 of 1"):
        trainer.train_epoch(loader, epoch=0)
