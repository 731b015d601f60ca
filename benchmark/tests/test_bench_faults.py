"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
tiny widths with the cell's own limits, once for each fault the cell can
have (one card: no exchange between chips to leave out)."""

import pytest

from _cells import tiny_cell
from harness import main


def run(name):
    return main.run(tiny_cell(name), 2 ** 31 + 77, 0.5, False, "cpu")


@pytest.mark.parametrize("name", ["vigor-train-b8", "kitti-train-b8"])
def test_state_left_unchanged(name, monkeypatch):
    from ccvpe_tpu_torch.train import step
    monkeypatch.setattr(step.Optimizer, "update", lambda self: None)
    r = run(name)
    assert r["correct"] is False and r["compared"]["change_median"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["vigor-train-b8", "kitti-train-b8"])
def test_half_the_batch_left_out(name, monkeypatch):
    from ccvpe_tpu_torch.train import step
    real = step.make_loss_fn

    def half(model, model_cfg, train_cfg):
        loss_fn = real(model, model_cfg, train_cfg)

        def on_half(batch, generator):
            h = batch.grd.shape[0] // 2
            return loss_fn(step.Batch(*(t[:h] for t in batch)), generator)
        return on_half
    monkeypatch.setattr(step, "make_loss_fn", half)
    assert run(name)["correct"] is False


@pytest.mark.parametrize("name", ["vigor-serve-b8", "kitti-serve-b8"])
def test_an_answer_altered(name, monkeypatch):
    from ccvpe_tpu_torch import serve
    real = serve.InferenceEngine._run

    def altered(self, grd, sat):
        rows, cols, angle, peak = real(self, grd, sat)
        h = self.model_cfg.sat_size[0]
        return [[(rows[0] + h // 4) % h] + rows[1:], cols, angle, peak]
    monkeypatch.setattr(serve.InferenceEngine, "_run", altered)
    r = run(name)
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("name", ["vigor-serve-b8", "vigor-train-b8"])
def test_sound_runs_are_correct(name):
    assert run(name)["correct"] is True
