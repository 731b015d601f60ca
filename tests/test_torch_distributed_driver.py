"""The port's Trainer and evaluation across 2 gloo ranks
(tests/_torch_dist.py) against one process, on tiny() and synthetic
splits, the port's counterpart of the JAX package's
tools/test_multiprocess.sh and tools/mp_train_worker.py:

- a 2-rank Trainer.fit of one epoch with validation, its loaders sharded
  (each rank a block of every global batch of 4), reproduces the
  one-process run's per-step losses within 1e-4 relative (the JAX
  package's own bound in tools/test_multiprocess.sh), and writes the
  same rows, from rank 0 only;
- a 2-rank run stopped by fake_fail_at_step and resumed from its
  checkpoint equals the uninterrupted 2-rank run to the bit, on both
  ranks;
- eval_over_loader and stream_eval over 2 shards pool the same per-sample
  errors, as a multiset, as one shard, and their summaries agree within
  1e-9 relative (float64 means over another order); stream_eval reports
  fps, aggregate_fps and the global frame count;
- scripts/train_oxford.py over 2 processes through its distributed flags
  trains and evaluates as one process does."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_dist import WORKER_THREADS, eval_runs, finish, oxford_script, start, trainer_runs
from _torch_driver import few_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("few_threads")

N_TRAIN, N_VAL, GLOBAL_BATCH, FAIL_AT = 8, 4, 4, 1
LOSS_RTOL, SUMMARY_RTOL, SCRIPT_RTOL = 1e-4, 1e-9, 1e-5
# one row a batch: a sample's float32 forward is then the same computation
# in either split (batches of other rows round the ori angle in another way)
N_EVAL, EVAL_BATCH = 7, 1


def rows(workdir):
    with open(os.path.join(workdir, "tiny.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in ("time", "pairs_per_s")}
                for line in f]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    one = tmp_path_factory.mktemp("one")
    two = tmp_path_factory.mktemp("two")
    args = (N_TRAIN, N_VAL, GLOBAL_BATCH, FAIL_AT, {})
    started = start("trainer_runs", 2, two, str(two), *args)
    return trainer_runs(str(one), *args), str(one), finish(started), str(two)


def test_two_rank_fit_reproduces_one_process_losses(fits):
    one, one_dir, _, two_dir = fits
    want, got = rows(f"{one_dir}/control"), rows(f"{two_dir}/control")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert [set(r) for r in got] == [set(r) for r in want]
    losses = [r for r in want if "loss" in r]
    assert len(losses) == N_TRAIN // GLOBAL_BATCH == one["step"]
    for g, w in zip(got, want):
        for k in (k for k in w if k.startswith("loss")):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {w['step']} {k}")
    assert any("val/median_distance_m" in r for r in got)


def test_metric_rows_come_from_rank_zero(fits):
    _, _, two, _ = fits
    assert [r["writes_rows"] for r in two] == [True, False]


def test_two_rank_resume_equals_uninterrupted(fits):
    _, _, two, two_dir = fits
    for r in two:
        assert r["failed"] == f"fake failure injected at step {FAIL_AT}"
        assert r["restored"] == (True, FAIL_AT, {"epoch": 0, "batch": FAIL_AT})
        assert r["resumed"] == r["control"]
    assert two[0]["control"] == two[1]["control"]
    control = rows(f"{two_dir}/control")
    # the failed step's loss row was never written
    assert rows(f"{two_dir}/resumed") == [r for r in control
                                          if r["step"] != FAIL_AT or "loss" not in r]


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    started = start("eval_runs", 2, tmp_path_factory.mktemp("ev"), N_EVAL, EVAL_BATCH, 7)
    # the ranks' intra-op threads: a conv's float32 sums split by thread
    threads = torch.get_num_threads()
    torch.set_num_threads(WORKER_THREADS)
    try:
        one = eval_runs(N_EVAL, EVAL_BATCH, 7)
    finally:
        torch.set_num_threads(threads)
    return one, finish(started)


def assert_summaries_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=SUMMARY_RTOL, err_msg=k)


@pytest.mark.parametrize("what", ["pooled", "stream_pooled"])
def test_pooled_errors_equal_one_shard(evals, what):
    one, two = evals
    assert len(one[what]) == len(two[0][what]) > 0
    for r in two:
        for got, want in zip(r[what], one[what]):
            assert len(got) == len(want) > 0
            np.testing.assert_array_equal(np.sort(got), np.sort(want))
    # rank order: rank 0's shard first
    assert [a.tolist() for a in two[0][what]] == [a.tolist() for a in two[1][what]]


def test_eval_over_loader_summary_equals_one_shard(evals):
    one, two = evals
    for r in two:
        assert_summaries_close(r["summary"], one["summary"])


def test_stream_eval_pools_and_reports_rates(evals):
    one, two = evals
    rates = ("fps", "aggregate_fps", "frames")
    for r in two:
        s = r["stream"]
        assert s["frames"] == one["stream"]["frames"] == N_EVAL
        assert s["fps"] > 0 and s["aggregate_fps"] > s["fps"]
        assert_summaries_close({k: v for k, v in s.items() if k not in rates},
                               {k: v for k, v in one["stream"].items() if k not in rates})
    assert one["stream"]["aggregate_fps"] == one["stream"]["fps"]


def test_oxford_script_over_two_processes(tmp_path, monkeypatch):
    """scripts/train_oxford.py with its distributed flags over 2 gloo
    processes (-b 2: one row each) against one process: training reaches
    the same step with the losses within LOSS_RTOL; evaluating one
    checkpoint (the one process's), the three traversals' summaries,
    pooled over both processes' frames (a traversal of one frame leaves one
    process none), are within SCRIPT_RTOL of one process's: one row a
    batch against two rounds a conv's float32 sums another way."""
    import _torch_data_roots as roots
    from ccvpe_tpu_torch.data import oxford
    monkeypatch.setattr(oxford, "OUT", 128)
    root, sat = roots.oxford_root(str(tmp_path / "oxford"))
    common = ["--preset", "tiny", "--epochs", "1", "-b", "2", "--num_workers", "1"]
    one_dir, two_dir = str(tmp_path / "one"), str(tmp_path / "two")
    started = start("oxford_script", 2, tmp_path / "train", root, sat, two_dir, common,
                    join=False)
    one = oxford_script(0, 1, None, root, sat, one_dir, common)
    assert finish(started) == [one, one] and one > 0
    want, got = rows(one_dir), rows(two_dir)
    assert [x["step"] for x in got] == [x["step"] for x in want]
    for g, w in zip(got, want):
        for k in (k for k in w if k.startswith("loss")):
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {w['step']} {k}")
    ckpt = f"{one_dir}/checkpoints"
    started = start("oxford_script", 2, tmp_path / "eval", root, sat, two_dir, common, ckpt,
                    join=False)
    one = oxford_script(0, 1, None, root, sat, one_dir, common, ckpt)
    for summaries in finish(started):
        assert [s["frames"] for s in summaries] == [s["frames"] for s in one] == [2.0, 1.0, 1.0]
        for g, w in zip(summaries, one):
            assert g.keys() == w.keys()
            for k in w.keys() - {"aggregate_fps"}:
                np.testing.assert_allclose(g[k], w[k], rtol=SCRIPT_RTOL, atol=1e-9, err_msg=k)
