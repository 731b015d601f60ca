"""Port vs JAX: stream_eval (the Oxford streaming loop) on tiny(), JAX
weights carried across by state_dict_from_jax, on the CPU.

The same per-frame decoded rows, cols and angles as the JAX loop, and the
same summary; pipeline_depth 1 and 4, and a padded tail batch against the
same frames in full batches, give the same results; the entry point takes
the card by default and refuses a model elsewhere, or more than one shard.

Tolerances as tests/test_torch_evaluate.py: angles per frame 1e-2 deg,
summary distances (m) and angles (deg) atol 1e-4, recalls and frame counts
equal; a differing argmax must be a tie of the JAX heatmap (TIE_ATOL, 1e-9,
_torch_helpers.py), at most one frame may so differ, and the summaries are
then compared over the other frames, recomputed from the per-frame outputs
with each package's own pose functions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import jax_variables, same_peaks
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.ops import pose as jpose
from ccvpe_tpu.train import stream as jstream
from ccvpe_tpu.train.step import make_eval_step as jax_eval_step
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.train.step import make_eval_step
from ccvpe_tpu_torch.train.stream import stream_eval
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

N, BATCH, MPP = 10, 4, 0.25
ANGLE_SAMPLE_ATOL = 1e-2
ANGLE_ATOL = DIST_ATOL = 1e-4


@dataclasses.dataclass
class Frame:
    grd: np.ndarray
    sat: np.ndarray
    row_offset: np.float32
    col_offset: np.float32
    angle_deg: np.float32


class SyntheticTraversal:
    def __init__(self, cfg, n):
        self.cfg, self.n = cfg, n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        r = np.random.default_rng(2000 + i)
        hg, wg = self.cfg.grd_size
        hs, ws = self.cfg.sat_size
        return Frame(grd=r.integers(0, 256, (hg, wg, 3), dtype=np.uint8),
                     sat=r.integers(0, 256, (hs, ws, 3), dtype=np.uint8),
                     row_offset=np.float32(r.uniform(-hs / 3, hs / 3)),
                     col_offset=np.float32(r.uniform(-ws / 3, ws / 3)),
                     angle_deg=np.float32(r.uniform(0, 360)))


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny()
    model = JaxCVM(cfg)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    variables = jax_variables(model, np.zeros((1, hg, wg, 3), np.float32),
                              np.zeros((1, hs, ws, 3), np.float32), False, seed=41)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return dict(cfg=cfg, model=model, variables=variables,
                port=build_cvm(tcfg.tiny(), "cpu", state_dict=sd),
                jax_step=jax_eval_step(model, cfg))


def port_stream(setup, store, n=N, depth=4, batch=BATCH):
    base = make_eval_step(setup["port"])

    def recording(grd, sat):
        out = base(grd, sat)
        store.append((grd, out))
        return out

    return stream_eval(setup["port"], tcfg.tiny(), SyntheticTraversal(setup["cfg"], 12),
                       range(n), batch_size=batch, meters_per_pixel=MPP, num_workers=2,
                       eval_step=recording, pipeline_depth=depth, device="cpu")


def port_frames(store, n=N):
    heatmap = torch.cat([h for _, (h, _) in store])[:n]
    ori = torch.cat([o for _, (_, o) in store])[:n]
    return heatmap, [t.numpy() for t in pose.decode_pose(heatmap, ori)]


def summary_over(pose_mod, frames, traversal, mask):
    """A stream's summary, without fps and frames, recomputed from its
    per-frame outputs (rows, cols, angle) over the frames of `mask`, with
    `pose_mod`'s functions (the JAX package's or the port's)."""
    idx = np.flatnonzero(mask)
    rows, cols, angle = (np.asarray(f)[idx] for f in frames)
    gt_angle = np.array([traversal[i].angle_deg for i in idx])
    gt_rows, gt_cols = pose_mod.gt_location(
        *traversal.cfg.sat_size, *(np.array([getattr(traversal[i], f) for i in idx])
                                   for f in ("row_offset", "col_offset")))
    dist = np.sqrt((gt_rows - rows) ** 2 + (gt_cols - cols) ** 2) * MPP
    ori = pose_mod.angle_error(angle, gt_angle)
    longi, lat = pose_mod.longitudinal_lateral(rows, cols, gt_rows, gt_cols, gt_angle, MPP)
    out = pose_mod.summarize(dist, ori)
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
        else:
            assert abs(got[k] - v) < (ANGLE_ATOL if "ori" in k else DIST_ATOL), (k, got[k], v)


def test_stream_eval_matches_jax(setup, monkeypatch):
    cfg, jax_step = setup["cfg"], setup["jax_step"]
    decode = jstream._get_decode_step(setup["model"], cfg, jax_step)
    jrec = []

    def recording(p, bs, grd, sat):
        out = decode(p, bs, grd, sat)
        jrec.append((grd, sat, out))
        return out

    monkeypatch.setitem(jstream._DECODE_STEP_CACHE, jax_step, recording)
    want = jstream.stream_eval(setup["model"], cfg, setup["variables"]["params"],
                               setup["variables"]["batch_stats"],
                               SyntheticTraversal(cfg, 12), range(N), batch_size=BATCH,
                               meters_per_pixel=MPP, num_workers=2, eval_step=jax_step)
    prec = []
    got = port_stream(setup, prec)
    assert len(prec) == 3 and all(len(g) == BATCH for g, _ in prec)    # tail padded
    want_s = [np.concatenate([np.asarray(o[i]) for _, _, o in jrec]) for i in range(3)]
    _, got_s = port_frames(prec)
    grd = np.concatenate([g for g, _, _ in jrec])
    sat = np.concatenate([s for _, s, _ in jrec])
    same = same_peaks(got_s[0], got_s[1], want_s[0], want_s[1], lambda idx: np.asarray(
        jax_step(setup["variables"]["params"], setup["variables"]["batch_stats"],
                 grd[idx], sat[idx])[0])[..., 0])
    np.testing.assert_allclose(got_s[2][same], want_s[2][same], atol=ANGLE_SAMPLE_ATOL)
    assert got.keys() == want.keys()
    assert got["frames"] == want["frames"] == N and got["fps"] > 0
    assert got["aggregate_fps"] == got["fps"]      # one process
    traversal = SyntheticTraversal(cfg, 12)
    rates = ("fps", "aggregate_fps", "frames")
    got_q, want_q = ({k: v for k, v in x.items() if k not in rates} for x in (got, want))
    everyone = np.ones(N, bool)
    assert_summaries_match(got_q, summary_over(pose, got_s, traversal, everyone))
    assert_summaries_match(want_q, summary_over(jpose, want_s, traversal, everyone))
    assert_summaries_match(summary_over(pose, got_s, traversal, same),
                           summary_over(jpose, want_s, traversal, same))
    if same.all():
        assert_summaries_match(got_q, want_q)


def test_depth_and_padding_leave_results_unchanged(setup):
    runs = {}
    for depth in (1, 4):
        for n in (N, 12):          # 12: the same first 10 frames, no padded batch
            store = []
            summary = port_stream(setup, store, n=n, depth=depth)
            runs[(depth, n)] = (summary, port_frames(store))
    ref_heat, ref_frames = runs[(1, N)][1]
    for key, (summary, (heat, frames)) in runs.items():
        torch.testing.assert_close(heat, ref_heat, rtol=0, atol=0, msg=str(key))
        for a, b in zip(frames, ref_frames):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    strip = lambda s: {k: v for k, v in s.items() if k not in ("fps", "aggregate_fps")}
    assert strip(runs[(1, N)][0]) == strip(runs[(4, N)][0])


def test_stream_eval_refusals(setup, monkeypatch):
    ds = SyntheticTraversal(setup["cfg"], 4)
    # a shard of 2 in a run of one process (2 shards pooled:
    # tests/test_torch_distributed_driver.py)
    with pytest.raises(ValueError, match="shard 0 of 2: this is process 0 of 1"):
        stream_eval(setup["port"], tcfg.tiny(), ds, range(4), num_shards=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_eval(setup["port"], tcfg.tiny(), ds, range(4))
    with pytest.raises(ValueError, match="lies on cpu"):
        stream_eval(setup["port"], tcfg.tiny(), ds, range(4), device="meta")
