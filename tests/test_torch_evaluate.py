"""Port vs JAX: the evaluation loops on tiny(), JAX weights carried across
by state_dict_from_jax, on the CPU (the correlation takes its plain version
on CPU tensors).

- eval_over_loader, at 360 degrees and at a FoV slice, with prob@GT on and
  off: the same per-sample decoded rows and cols, GT pixels equal to the
  host gt_location at the test's offsets, and the same summary.
- pipeline_depth 1 and 4, and a padded tail batch against the same samples
  in a full batch, give the same per-sample results.
- evaluate_vigor (the fixed test orientations, the orientation prior, a
  FoV slice) and evaluate_kitti through an args namespace on synthetic
  roots, against the JAX functions; both packages' presets are swapped for
  tiny() and the datasets' image sizes cut to tiny's, so the whole path
  runs here in seconds (the real geometry is test_torch_cvm.py's slow
  cases and chip_smoke.py's eval phase).
- device=None means the card and raises without one; more than one shard
  raises NotImplementedError.

Tolerances: decoded angles per sample 1e-2 deg (acos near +-1 magnifies the
orientation field's ~1e-6 differences); summaries, distances in metres and
angles in degrees, atol 1e-4 (ANGLE_ATOL), recalls equal; prob@GT atol
HEATMAP_ATOL. Where the port's argmax differs from the JAX one, the two JAX
heatmap values must lie within TIE_ATOL (1e-9, _torch_helpers.py) of each
other: a tie of the random model, not a port fault. At most one sample may
so differ; the summaries are then compared over the other samples,
recomputed from the per-sample outputs with each package's own pose
functions, and each loop's summary is held to that recomputation over all
its samples.
"""

import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_data_roots as roots
from _torch_helpers import HEATMAP_ATOL, jax_variables, same_peaks
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.data import kitti as jkitti
from ccvpe_tpu.data import vigor as jvigor
from ccvpe_tpu.data.loader import ThreadedLoader as JaxLoader
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.ops import pose as jpose
from ccvpe_tpu.train import evaluate as jevaluate
from ccvpe_tpu.train.step import device_normalize as jax_normalize
from ccvpe_tpu.train.step import make_eval_decode_step as jax_decode_step
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.data import kitti, vigor
from ccvpe_tpu_torch.data.loader import ThreadedLoader
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.train import evaluate
from ccvpe_tpu_torch.train.step import make_eval_decode_step
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

N, BATCH = 10, 4                 # three batches, the last of 2 rows
ANGLE_SAMPLE_ATOL = 1e-2
ANGLE_ATOL = DIST_ATOL = 1e-4
CITIES = ("NewYork", "Seattle", "SanFrancisco", "Chicago")
MPP = {c: vigor.METER_PER_PIXEL[c] / 128 * 640 for c in CITIES}


@dataclasses.dataclass
class Sample:
    grd: np.ndarray
    sat: np.ndarray
    row_offset: np.float32
    col_offset: np.float32
    angle_deg: np.float32
    city: str


class SyntheticSplit:
    """Seeded per-index samples at tiny's geometry, with VIGOR's fields."""

    def __init__(self, cfg, n):
        self.cfg, self.n = cfg, n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        r = np.random.default_rng(1000 + i)
        hg, wg = self.cfg.grd_size
        hs, ws = self.cfg.sat_size
        return Sample(grd=r.normal(size=(hg, wg, 3)).astype(np.float32),
                      sat=r.normal(size=(hs, ws, 3)).astype(np.float32),
                      row_offset=np.float32(r.uniform(-hs / 3, hs / 3)),
                      col_offset=np.float32(r.uniform(-ws / 3, ws / 3)),
                      angle_deg=np.float32(r.uniform(0, 360)), city=CITIES[i % 4])


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny()
    model = JaxCVM(cfg)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    variables = jax_variables(model, np.zeros((1, hg, wg, 3), np.float32),
                              np.zeros((1, hs, ws, 3), np.float32), False, seed=31)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    port = build_cvm(tcfg.tiny(), "cpu", state_dict=sd)
    heatmap = jax.jit(lambda v, g, s: model.apply(
        v, jax_normalize(g), jax_normalize(s), False).heatmap[..., 0])
    # one jitted JAX step for every loop of this file: one compile a shape
    return dict(cfg=cfg, model=model, variables=variables, state_dict=sd, port=port,
                jax_step=jax_decode_step(model, cfg),
                heatmap=lambda g, s: np.asarray(heatmap(variables, g, s)))


def recording(step, store):
    def wrapped(*args):
        out = step(*args)
        store.append((args, out))
        return out
    return wrapped


def per_sample(store, n):
    """(inputs, outputs) per call -> inputs and outputs as numpy, one row a
    sample, padded rows dropped."""
    ins = [np.concatenate([np.asarray(a[i]) for a, _ in store])[:n] for i in range(2)]
    outs = [np.concatenate([np.asarray(o[i]) for _, o in store])[:n] for i in range(6)]
    return ins, outs


def summary_over(pose_mod, outs, split, mask, with_prob):
    """A loop's summary recomputed from its per-sample outputs (rows, cols,
    angle, GT rows, GT cols, prob@GT) over the samples of `mask`, with
    `pose_mod`'s functions (the JAX package's or the port's)."""
    idx = np.flatnonzero(mask)
    rows, cols, angle, gt_rows, gt_cols, prob = (np.asarray(o)[idx] for o in outs)
    gt_angle = np.array([split[i].angle_deg for i in idx])
    mpp = np.array([MPP[split[i].city] for i in idx])
    dist = np.sqrt((gt_rows - rows) ** 2.0 + (gt_cols - cols) ** 2.0) * mpp
    ori = pose_mod.angle_error(angle, gt_angle)
    longi, lat = pose_mod.longitudinal_lateral(rows, cols, gt_rows, gt_cols, gt_angle, mpp)
    out = pose_mod.summarize(dist, ori, prob if with_prob else None)
    for name, errs in (("long_", longi), ("lat_", lat)):
        out.update({name + k: v for k, v in pose_mod.recalls(errs).items()})
    out.update({k.replace("recall@", "ori_recall@") + "deg": v
                for k, v in pose_mod.recalls(ori).items()})
    return out


def assert_summaries_match(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if "recall" in k:
            assert got[k] == v, k
        elif "prob" in k:
            assert abs(got[k] - v) < HEATMAP_ATOL, k
        else:
            assert abs(got[k] - v) < (ANGLE_ATOL if "ori" in k else DIST_ATOL), (k, got[k], v)


CASES = {"360, prob@GT": (None, True), "360": (None, False), "FoV 180, prob@GT": (180, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_over_loader_matches_jax(setup, case):
    fov, with_prob = CASES[case]
    cfg = setup["cfg"]
    split = SyntheticSplit(cfg, N)
    mpp = MPP.__getitem__
    jrec, prec = [], []
    want = jevaluate.eval_over_loader(
        recording(setup["jax_step"], jrec),
        setup["variables"]["params"], setup["variables"]["batch_stats"],
        JaxLoader(split, BATCH, shuffle=False, drop_last=False, num_workers=2), cfg, mpp,
        fov=fov, with_prob_at_gt=with_prob)
    got = evaluate.eval_over_loader(
        recording(make_eval_decode_step(setup["port"]), prec),
        ThreadedLoader(split, BATCH, shuffle=False, drop_last=False, num_workers=2), mpp,
        fov=fov, with_prob_at_gt=with_prob, device="cpu")
    # the JAX step's args are (params, batch_stats, grd, sat, ...)
    (grd, sat), want_s = per_sample([(a[2:], o) for a, o in jrec], N)
    (pgrd, _), got_s = per_sample(prec, N)
    assert len(prec) == 3 and all(len(o[0]) == BATCH for _, o in prec)   # tail padded
    np.testing.assert_array_equal(pgrd, grd)
    assert grd.shape[2] == (cfg.grd_size[1] * fov // 360 if fov else cfg.grd_size[1])
    same = same_peaks(got_s[0], got_s[1], want_s[0], want_s[1],
                      lambda idx: setup["heatmap"](grd[idx], sat[idx]))
    # GT pixels: the device's equal the JAX device's and the host gt_location
    offsets = [np.array([getattr(split[i], f) for i in range(N)])
               for f in ("row_offset", "col_offset")]
    host = pose.gt_location(*cfg.sat_size, *offsets)
    for k in (3, 4):
        np.testing.assert_array_equal(got_s[k], want_s[k])
        np.testing.assert_array_equal(got_s[k], host[k - 3])
    np.testing.assert_allclose(got_s[2][same], want_s[2][same], atol=ANGLE_SAMPLE_ATOL)
    np.testing.assert_allclose(got_s[5], want_s[5], atol=HEATMAP_ATOL)
    everyone = np.ones(N, bool)
    assert_summaries_match(got, summary_over(pose, got_s, split, everyone, with_prob))
    assert_summaries_match(want, summary_over(jpose, want_s, split, everyone, with_prob))
    assert_summaries_match(summary_over(pose, got_s, split, same, with_prob),
                           summary_over(jpose, want_s, split, same, with_prob))
    if same.all():
        assert_summaries_match(got, want)


def run_pipelined(port, split, depth, n):
    step = make_eval_decode_step(port)
    loader = ThreadedLoader(split, BATCH, shuffle=False, drop_last=False, num_workers=2)
    inputs = lambda raw: (raw["grd"], raw["sat"], raw["row_offset"], raw["col_offset"])
    outs = [o for o, _ in evaluate.pipelined(step, loader, inputs, BATCH,
                                             torch.device("cpu"), depth)]
    assert [len(o[0]) for o in outs] == [min(BATCH, n - i) for i in range(0, n, BATCH)]
    return [np.concatenate(col)[:N] for col in zip(*outs)]


def test_depth_and_padding_leave_results_unchanged(setup):
    cfg = setup["cfg"]
    ragged = SyntheticSplit(cfg, N)           # 4 + 4 + 2, the tail padded
    full = SyntheticSplit(cfg, 12)            # the same 10 samples in full batches
    runs = {(d, n): run_pipelined(setup["port"], split, d, n)
            for d in (1, 4) for n, split in ((N, ragged), (12, full))}
    for key, outs in runs.items():
        for a, b in zip(outs, runs[(1, N)]):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    summaries = [evaluate.eval_over_loader(
        make_eval_decode_step(setup["port"]),
        ThreadedLoader(ragged, BATCH, shuffle=False, drop_last=False, num_workers=2),
        MPP.__getitem__, pipeline_depth=d, device="cpu") for d in (1, 4)]
    assert summaries[0] == summaries[1]


def test_gt_location_device_matches_host(rng):
    r = rng.uniform(-64, 64, 257).astype(np.float32)
    c = rng.uniform(-64, 64, 257).astype(np.float32)
    ys = np.linspace(-64.0, 64.0, 128)
    r[:5] = (ys[3:8] + ys[4:9]) / 2            # offsets halfway between grid nodes
    hr, hc = pose.gt_location(128, 128, r, c)
    dr, dc = pose.gt_location_device(128, 128, torch.from_numpy(r), torch.from_numpy(c))
    np.testing.assert_array_equal(dr.numpy(), hr)
    np.testing.assert_array_equal(dc.numpy(), hc)


@pytest.fixture
def tiny_presets(monkeypatch):
    """Both packages' vigor() and kitti() give tiny() (with the prior and
    padding asked for), and the datasets load at tiny's image sizes."""
    for cfg_mod in (jcfg, tcfg):
        base = cfg_mod.tiny()
        monkeypatch.setattr(cfg_mod, "vigor", lambda ori_noise=None, circular=True, b=base:
                            dataclasses.replace(b, ori_noise=ori_noise, circular=circular))
        monkeypatch.setattr(cfg_mod, "kitti", lambda b=base: b)
    for mod, owner in ((jvigor, jvigor), (vigor, evaluate)):
        small = type("SmallVIGOR", (mod.VIGORDataset,), {"__init__": (
            lambda self, *a, _c=mod.VIGORDataset, **k: _c.__init__(
                self, *a, grd_size=(64, 128), sat_size=(128, 128), **k))})
        monkeypatch.setattr(owner, "VIGORDataset", small)
    for mod, owner in ((jkitti, jkitti), (kitti, evaluate)):
        small = type("SmallKitti", (mod.KittiDataset,), {"__init__": (
            lambda self, *a, _c=mod.KittiDataset, **k: _c.__init__(
                self, *a, grd_size=(64, 128), **k))})
        monkeypatch.setattr(owner, "KittiDataset", small)
        monkeypatch.setattr(mod, "SAT_SIZE", 128)
    monkeypatch.setenv("CCVPE_NATIVE_IO", "0")


@pytest.fixture(scope="module")
def checkpoint(setup, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "model.pt")
    torch.save(setup["state_dict"], path)
    return path


@pytest.fixture(scope="module")
def vigor_dir(tmp_path_factory):
    return roots.vigor_root(str(tmp_path_factory.mktemp("vigor")))


VIGOR_CASES = {"fixed orientations": (180.0, 360, "samearea"),
               "ori prior 90": (90.0, 360, "crossarea"),
               "FoV 180": (180.0, 180, "samearea")}


@pytest.mark.parametrize("case", list(VIGOR_CASES))
def test_evaluate_vigor_matches_jax(tiny_presets, checkpoint, vigor_dir, monkeypatch, tmp_path,
                                    case):
    ori_noise, fov, area = VIGOR_CASES[case]
    monkeypatch.setenv("CCVPE_REFERENCE", str(tmp_path))   # the packaged fixtures
    args = argparse.Namespace(root=vigor_dir, area=area, checkpoint=checkpoint,
                              batch_size=BATCH, num_workers=2, FoV=fov)
    want = jevaluate.evaluate_vigor(args, ori_noise, circular=True)
    got = evaluate.evaluate_vigor(args, ori_noise, circular=True, device="cpu")
    assert "mean_prob_at_gt" in got
    assert_summaries_match(got, want)


def test_evaluate_kitti_matches_jax(tiny_presets, checkpoint, tmp_path):
    root, _, test1, test2 = roots.kitti_root(str(tmp_path))
    args = argparse.Namespace(root=root, test1_file=test1, test2_file=test2,
                              checkpoint=checkpoint, batch_size=BATCH, num_workers=2,
                              shift_range_lat=20.0, shift_range_lon=20.0, rotation_range=10.0)
    want = jevaluate.evaluate_kitti(args)
    got = evaluate.evaluate_kitti(args, device="cpu")
    assert got.keys() == want.keys() == {"test1", "test2"}
    for name in got:
        assert "lat_recall@1" in got[name]
        assert_summaries_match(got[name], want[name])


def test_entry_points_refuse(setup, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    split = SyntheticSplit(setup["cfg"], 4)
    step = make_eval_decode_step(setup["port"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.eval_over_loader(step, ThreadedLoader(split, BATCH), 1.0)
    args = argparse.Namespace(root="unused", checkpoint="unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.evaluate_kitti(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.evaluate_vigor(args, 180.0, True)
    # a shard of 2 in a run of one process (2 shards pooled:
    # tests/test_torch_distributed_driver.py)
    with pytest.raises(ValueError, match="shard 0 of 2: this is process 0 of 1"):
        evaluate.eval_over_loader(step, ThreadedLoader(split, 2, num_shards=2), 1.0,
                                  device="cpu")
    with pytest.raises(ValueError, match="directory"):
        evaluate.load_model(tcfg.tiny(), str(tmp_path), "cpu")
