"""The port's train scripts (ccvpe_tpu_torch/scripts/train_*.py) end to end
on the CPU: each main() with --preset tiny --device cpu --epochs 1 on the
synthetic roots of _torch_data_roots.py trains, validates and leaves a
checkpoint under <workdir>/checkpoints, and --training False --checkpoint
<that directory> evaluates from it (VIGOR and KITTI through
evaluate_vigor / evaluate_kitti, Oxford through stream_eval over its three
traversals). The datasets' aerial sizes are cut to tiny's 128 and the
evaluation presets swapped for tiny(), as in test_torch_evaluate.py, so each
runs in seconds. Without --device the scripts take the card, and raise
without one."""

import dataclasses
import math

import pytest
import torch

import _torch_data_roots as roots
from _torch_driver import few_threads  # noqa: F401 (a fixture)
from ccvpe_tpu_torch.core import checkpoint as ckpt_lib
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.data import kitti, oxford, vigor
from ccvpe_tpu_torch.scripts import train_kitti, train_oxford, train_vigor
from ccvpe_tpu_torch.train import evaluate

pytestmark = pytest.mark.usefixtures("few_threads")

TINY_GRD = (64, 128)
COMMON = ["--preset", "tiny", "--epochs", "1", "-b", "2", "--num_workers", "2"]


@pytest.fixture
def small(monkeypatch, tmp_path):
    """tiny() for the evaluation presets, tiny's image sizes for the
    datasets, the packaged orientation fixtures."""
    base = tcfg.tiny()
    monkeypatch.setattr(tcfg, "vigor", lambda ori_noise=None, circular=True: dataclasses.replace(
        base, ori_noise=ori_noise, circular=circular))
    monkeypatch.setattr(tcfg, "kitti", lambda: base)
    monkeypatch.setattr(kitti, "SAT_SIZE", 128)
    monkeypatch.setattr(oxford, "OUT", 128)
    for name, cls, sizes in (("VIGORDataset", vigor.VIGORDataset,
                              dict(grd_size=TINY_GRD, sat_size=(128, 128))),
                             ("KittiDataset", kitti.KittiDataset, dict(grd_size=TINY_GRD))):
        small_cls = type(f"Small{name}", (cls,), {"__init__": (
            lambda self, *a, _c=cls, _s=sizes, **k: _c.__init__(self, *a, **{**k, **_s}))})
        monkeypatch.setattr(evaluate, name, small_cls)
    monkeypatch.setenv("CCVPE_REFERENCE", str(tmp_path))


def _roots(name, tmp_path):
    if name == "vigor":
        return ["--root", roots.vigor_root(str(tmp_path / "vigor"))]
    if name == "kitti":
        root, train, test1, test2 = roots.kitti_root(str(tmp_path / "kitti"))
        return ["--root", root, "--train_file", train, "--test1_file", test1,
                "--test2_file", test2, "--rotation_range", "10"]
    root, sat = roots.oxford_root(str(tmp_path / "oxford"))
    return ["--grd_root", root, "--sat_path", sat]


SCRIPTS = {"vigor": train_vigor, "kitti": train_kitti, "oxford": train_oxford}


def _finite(summary):
    return all(math.isfinite(v) for v in summary.values())


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_train_then_evaluate_the_checkpoint(small, tmp_path, name):
    script, data = SCRIPTS[name], _roots(name, tmp_path)
    workdir = str(tmp_path / "run")
    trainer = script.main(data + COMMON + ["--device", "cpu", "--workdir", workdir])
    ckpt_dir = f"{workdir}/checkpoints"
    steps = ckpt_lib.saved_steps(ckpt_dir)
    assert steps and steps[-1] == trainer.state.step > 0
    with open(f"{workdir}/tiny.jsonl") as f:
        assert "median_distance_m" in f.read()

    result = script.main(data + COMMON + ["--device", "cpu", "--training", "False",
                                          "--checkpoint", ckpt_dir])
    if name == "vigor":
        assert "mean_prob_at_gt" in result and _finite(result)
    elif name == "kitti":
        assert result.keys() == {"test1", "test2"} and all(map(_finite, result.values()))
    else:
        assert [s["frames"] for s in result] == [2.0, 1.0, 1.0]
        assert all(map(_finite, result))


@pytest.mark.parametrize("name", list(SCRIPTS))
@pytest.mark.parametrize("training", ["True", "False"])
def test_scripts_default_to_the_card(small, tmp_path, monkeypatch, name, training):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRIPTS[name].main(_roots(name, tmp_path) + COMMON + [
            "--training", training, "--workdir", str(tmp_path / "run"),
            "--checkpoint", str(tmp_path / "missing.pt")])
