"""The port's visualize_vigor.py and parity_eval.py
(ccvpe_tpu_torch/scripts/) against the JAX package's scripts
(scripts/visualize_vigor.py, scripts/parity_eval.py) on the same .pt
(tiny() weights from state_dict_from_jax) and the synthetic roots of
_torch_data_roots.py. Both packages' presets are swapped for tiny() and the
datasets' image sizes cut to tiny's, as in test_torch_evaluate.py, so the
scripts run here in seconds; the real geometry is chip_smoke.py's.

- visualize_vigor: what each hands render_qualitative: the images equal,
  the heatmap within HEATMAP_ATOL, the orientation field within ORI_ATOL,
  GT pixel and angle equal, the predicted pixel equal (ties as
  _torch_helpers.same_peaks); the port's PNG is written.
- parity_eval: the same table within the eval tests' tolerance (distances
  and angles atol 1e-4, recalls equal, prob@GT HEATMAP_ATOL): the VIGOR
  section in the fast lane, all three sections in the slow one (the JAX
  suite's own all-section run, tests/test_parity_eval.py, is slow).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import _torch_data_roots as roots
from _torch_helpers import (HEATMAP_ATOL, jax_variables, one_intra_op_thread,  # noqa: F401
                            same_peaks)
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.data import kitti as jkitti
from ccvpe_tpu.data import oxford as joxford
from ccvpe_tpu.data import vigor as jvigor
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.utils import viz as jviz
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.data import kitti, oxford, vigor
from ccvpe_tpu_torch.scripts import parity_eval, visualize_vigor
from ccvpe_tpu_torch.train import evaluate
from ccvpe_tpu_torch.utils import viz
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import parity_eval as jax_parity_eval  # noqa: E402
import visualize_vigor as jax_visualize_vigor  # noqa: E402

ORI_ATOL = 1e-5
DIST_ATOL = ANGLE_ATOL = 1e-4
TINY_GRD = (64, 128)


@pytest.fixture
def tiny_presets(monkeypatch, tmp_path):
    """Both packages' vigor(), kitti() and oxford() give tiny() (with the
    prior and padding asked for); the datasets load at tiny's image sizes;
    the packaged orientation fixtures; PIL decoding on the JAX side."""
    for cfg_mod in (jcfg, tcfg):
        base = cfg_mod.tiny()
        monkeypatch.setattr(cfg_mod, "vigor", lambda ori_noise=None, circular=True, b=base:
                            dataclasses.replace(b, ori_noise=ori_noise, circular=circular))
        monkeypatch.setattr(cfg_mod, "kitti", lambda b=base: b)
        monkeypatch.setattr(cfg_mod, "oxford", lambda b=base: dataclasses.replace(b, name="oxford"))
    small = dict(VIGORDataset=dict(grd_size=TINY_GRD, sat_size=(128, 128)),
                 KittiDataset=dict(grd_size=TINY_GRD), OxfordDataset=dict(grd_size=TINY_GRD))
    for name, owners in (("VIGORDataset", (jvigor, vigor, evaluate)),
                         ("KittiDataset", (jkitti, evaluate)),
                         ("OxfordDataset", (joxford, oxford))):
        for owner in owners:
            cls = getattr(owner, name)
            monkeypatch.setattr(owner, name, type(f"Small{name}", (cls,), {"__init__": (
                lambda self, *a, _c=cls, _s=small[name], **k: _c.__init__(self, *a, **k, **_s))}))
    for mod in (jkitti, kitti):
        monkeypatch.setattr(mod, "SAT_SIZE", 128)
    for mod in (joxford, oxford):
        monkeypatch.setattr(mod, "OUT", 128)
    monkeypatch.setenv("CCVPE_NATIVE_IO", "0")
    monkeypatch.setenv("CCVPE_REFERENCE", str(tmp_path))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = jcfg.tiny()
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    variables = jax_variables(JaxCVM(cfg), np.zeros((1, hg, wg, 3), np.float32),
                              np.zeros((1, hs, ws, 3), np.float32), False, seed=51)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pt")
    torch.save(state_dict_from_jax(variables["params"], variables["batch_stats"]), path)
    return path


@pytest.fixture(scope="module")
def vigor_dir(tmp_path_factory):
    return roots.vigor_root(str(tmp_path_factory.mktemp("vigor")))


def recorded(monkeypatch, module, store, render=True):
    real = module.render_qualitative

    def record(*args, **kwargs):
        store.update(args=args, kwargs=kwargs)
        return real(*args, **kwargs) if render else kwargs["out_path"]
    monkeypatch.setattr(module, "render_qualitative", record)


def test_visualize_vigor_matches_jax(tiny_presets, checkpoint, vigor_dir, monkeypatch, tmp_path):
    got, want = {}, {}
    recorded(monkeypatch, viz, got)
    recorded(monkeypatch, jviz, want, render=False)
    common = ["--root", vigor_dir, "--checkpoint", checkpoint, "--index", "5"]
    out = str(tmp_path / "port.png")
    assert visualize_vigor.main(common + ["--out", out, "--device", "cpu"]) == out
    assert os.path.getsize(out) > 1000
    monkeypatch.setattr(sys, "argv", ["visualize_vigor.py"] + common + ["--out", "jax.png"])
    jax_visualize_vigor.main()
    (grd, sat, heat, ori), (jgrd, jsat, jheat, jori) = got["args"][:4], want["args"][:4]
    np.testing.assert_array_equal(grd, jgrd)
    np.testing.assert_array_equal(sat, jsat)
    np.testing.assert_allclose(heat, jheat, atol=HEATMAP_ATOL, rtol=0)
    np.testing.assert_allclose(ori, jori, atol=ORI_ATOL, rtol=0)
    assert got["kwargs"]["gt_rc"] == want["kwargs"]["gt_rc"]
    assert got["kwargs"]["angle_deg"] == want["kwargs"]["angle_deg"]
    (pr, pc), (jr, jc) = got["kwargs"]["pred_rc"], want["kwargs"]["pred_rc"]
    same_peaks([pr], [pc], [jr], [jc], lambda idx: jheat[None])


def assert_tables_match(got, want):
    assert got.keys() == want.keys()
    for section in want:
        assert got[section].keys() == want[section].keys(), section
        for row, metrics in want[section].items():
            assert got[section][row].keys() == metrics.keys(), (section, row)
            for k, v in metrics.items():
                g = got[section][row][k]
                if "recall" in k or k == "frames":
                    assert g == v, (section, row, k)
                elif "prob" in k:
                    assert abs(g - v) < HEATMAP_ATOL, (section, row, k)
                elif "fps" not in k:
                    assert abs(g - v) < (ANGLE_ATOL if "ori" in k else DIST_ATOL), (
                        section, row, k, g, v)


def run_both(args, tmp_path):
    got = parity_eval.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    want = jax_parity_eval.main(args + ["--out", str(tmp_path / "jax.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    return got, want


def test_parity_eval_vigor_section_matches_jax(tiny_presets, checkpoint, vigor_dir, tmp_path):
    got, want = run_both(["--vigor_root", vigor_dir, "--vigor_samearea_ckpt", checkpoint,
                          "--batch_size", "4", "--num_workers", "2"], tmp_path)
    assert set(got["vigor"]) == {"samearea/known_ori", "samearea/unknown_ori"}
    assert "mean_prob_at_gt" in got["vigor"]["samearea/known_ori"]
    assert_tables_match(got, want)


@pytest.mark.slow
def test_parity_eval_all_sections_match_jax(tiny_presets, checkpoint, vigor_dir, tmp_path):
    kroot, _, test1, test2 = roots.kitti_root(str(tmp_path / "kitti"))
    ogrd, osat = roots.oxford_root(str(tmp_path / "oxford"))
    got, want = run_both([
        "--vigor_root", vigor_dir, "--vigor_samearea_ckpt", checkpoint,
        "--kitti_root", kroot, "--kitti_ckpt", checkpoint, "--kitti_test1", test1,
        "--kitti_test2", test2, "--oxford_grd_root", ogrd, "--oxford_sat_path", osat,
        "--oxford_ckpt", checkpoint, "--batch_size", "2", "--num_workers", "2"], tmp_path)
    assert set(got) == {"vigor", "kitti", "oxford"}
    assert set(got["kitti"]) == {"test1", "test2"}
    assert set(got["oxford"]) == {"traversal1", "traversal2", "traversal3"}
    assert_tables_match(got, want)
