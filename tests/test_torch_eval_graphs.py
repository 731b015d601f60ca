"""The eval steps' CUDA graphs as far as the CPU shows them (the graphs
themselves run only on the card: chip_smoke.py phase 10 holds graphed eval
loops to eager ones there, to the bit, and their launches to a
torch.profiler trace; phase 11 the Trainer's graphed validation):

- core/graphs.py::GraphCache with stand-in graphs: the first call of a key
  runs eagerly, the second captures and replays, the third replays; a new
  shape or another binding captures again; a failed capture raises and
  leaves the launch counters as they were; outputs are clones, which the
  next call does not overwrite (an emulated replay re-runs the captured
  work into the static outputs, as a CUDA graph's replay rewrites them);
- cuda_graph=True on CPU eval steps, eval_over_loader, stream_eval and
  Trainer.validate runs eagerly and gives the eager results to the bit;
  through the graphed path with the emulated replay they give those bits
  too (an in-place load_state_dict, or the train step's updates, keep the
  graph and are read by its next replay), and still match the JAX package
  within tests/test_torch_evaluate.py's and test_torch_stream.py's
  tolerances;
- stream_eval keeps one step a model across calls (one capture) and drops
  it with the model; a caller's eval_step is called as given;
- the refusals: anomaly mode, and a model axis whose collectives a gloo
  group cannot capture; a data axis alone under gloo graphs.

Tolerance: none between the port's runs (bit equality); JAX as in
test_torch_evaluate.py and test_torch_stream.py."""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax

import test_torch_evaluate as tev
import test_torch_stream as tst
from _torch_driver import few_threads, SyntheticDataset, train_loaders, val_loaders  # noqa: F401
from _torch_helpers import jax_variables
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.data.loader import ThreadedLoader as JaxLoader
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.train import evaluate as jevaluate
from ccvpe_tpu.train import stream as jstream
from ccvpe_tpu.train.step import device_normalize as jax_normalize
from ccvpe_tpu.train.step import make_eval_decode_step as jax_decode_step
from ccvpe_tpu.train.step import make_eval_step as jax_eval_step
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.core.graphs import Graph, GraphCache, read_counts
from ccvpe_tpu_torch.data.loader import ThreadedLoader
from ccvpe_tpu_torch.models.cvm import CVM, build_cvm, random_init_
from ccvpe_tpu_torch.ops import corr_cuda, pose
from ccvpe_tpu_torch.train import evaluate, stream
from ccvpe_tpu_torch.train import step as tstep
from ccvpe_tpu_torch.train.step import make_eval_decode_step, make_eval_step
from ccvpe_tpu_torch.train.stream import stream_eval
from ccvpe_tpu_torch.train.trainer import Trainer
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

pytestmark = pytest.mark.usefixtures("few_threads")

B = 2


class StandIn:
    """What Graph asks of a torch.cuda.CUDAGraph, counted."""

    def __init__(self):
        self.replays = 0

    def register_generator_state(self, generator):
        pass

    def replay(self):
        self.replays += 1


def stand_in_graph() -> Graph:
    return Graph(StandIn(), context=lambda graph: contextlib.nullcontext())


class Replayed(Graph):
    """A stand-in graph whose replay re-runs the captured work and writes
    its results into the static outputs, as a CUDA graph's replay rewrites
    them. It keeps the work (and what the work closes over) alive."""

    def __init__(self):
        super().__init__(StandIn(), context=lambda graph: contextlib.nullcontext())

    def capture(self, fn, generators=()):
        self._fn = fn
        self._out = super().capture(fn, generators)
        return self._out

    def replay(self):
        super().replay()
        for static, new in zip(self._out, self._fn()):
            static.copy_(new)


def graphed_on_the_cpu(monkeypatch, make_graph):
    """The eval steps take the graphed path on the CPU, with `make_graph`."""
    monkeypatch.setattr(tstep, "graph_cache", lambda device, cuda_graph: (
        GraphCache(device, make_graph) if cuda_graph else None))


# --- GraphCache's bookkeeping ---

def test_graph_cache_runs_eagerly_then_captures_then_replays():
    cache = GraphCache("cpu", stand_in_graph)
    calls = []

    def fn(x):
        calls.append(x.shape)
        corr_cuda.corr_core.launches += 6          # what the wrapper does where it launches
        return (x + 1,)

    before = read_counts()
    x = torch.zeros(3)
    assert torch.equal(cache(fn, "model", x)[0], x + 1)      # eager
    assert (len(calls), cache.captures) == (1, 0)
    cache(fn, "model", x)                                     # captures, replays once
    assert (len(calls), cache.captures) == (2, 1)
    (entry,) = cache._graphs.values()
    graph = entry.graph
    assert graph.cuda_graph.replays == 1 and graph.launches[0] == 6
    cache(fn, "model", x)                                     # replays
    assert (len(calls), cache.captures, graph.cuda_graph.replays) == (2, 1, 2)
    # each call counts the launches an eager call counts
    assert read_counts()[0] - before[0] == 18


def test_graph_cache_captures_again_for_a_new_shape_or_binding():
    cache = GraphCache("cpu", stand_in_graph)
    fn = lambda x: (x * 2,)                                   # noqa: E731
    small, large = torch.ones(2), torch.ones(4)
    for x in (small, small, large, large):
        cache(fn, "a", x)
    assert cache.captures == 2
    cache(fn, "a", small.double())                            # another dtype: eager
    assert cache.captures == 2
    cache(fn, "b", small)                                     # another binding: eager first
    assert cache.captures == 2
    cache(fn, "b", small)
    assert cache.captures == 3
    assert cache._graphs[(((2,), torch.float32),)].binding == "b"


def test_graph_cache_failed_capture_raises_and_restores_the_counters():
    cache = GraphCache("cpu", stand_in_graph)
    n = [0]

    def fn(x):
        n[0] += 1
        corr_cuda.corr_core.launches += 6
        if n[0] > 1:
            raise RuntimeError("operation not permitted when stream is capturing")
        return (x,)

    x = torch.zeros(2)
    cache(fn, None, x)
    before = read_counts()
    for _ in range(2):          # no fallback: every capture that fails raises
        with pytest.raises(RuntimeError, match="capturing"):
            cache(fn, None, x)
        assert read_counts() == before and cache.captures == 0 and not cache._graphs


def test_graph_cache_outputs_are_not_overwritten():
    cache = GraphCache("cpu", Replayed)
    outs = [cache(lambda x: (x * 2, x.sum()), None, torch.full((3,), float(i)))
            for i in range(4)]
    for i, (doubled, total) in enumerate(outs):
        assert torch.equal(doubled, torch.full((3,), 2.0 * i)) and total.item() == 3.0 * i
    assert cache.captures == 1


# --- the eval steps on tiny() ---

@pytest.fixture(scope="module")
def weights():
    def draw(seed):
        return random_init_(CVM(tcfg.tiny()).to_empty(device="cpu"),
                            torch.Generator().manual_seed(seed)).state_dict()
    return draw(5), draw(6)


def _inputs(cfg, seed, b=B):
    rng = np.random.default_rng(seed)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    return (torch.from_numpy(rng.integers(0, 256, (b, hg, wg, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (b, hs, ws, 3), dtype=np.uint8)),
            torch.from_numpy(rng.uniform(-20, 20, b).astype(np.float32)),
            torch.from_numpy(rng.uniform(-20, 20, b).astype(np.float32)))


MAKERS = {"eval_step": (make_eval_step, 2), "eval_decode_step": (make_eval_decode_step, 4)}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(MAKERS))
def test_cuda_graph_on_the_cpu_is_eager(weights, name):
    make, n_in = MAKERS[name]
    model = build_cvm(tcfg.tiny(), "cpu", state_dict=weights[0])
    graphed, eager = make(model), make(model, cuda_graph=False)
    assert graphed.graphs is None and graphed.takes_host_inputs
    for seed in (1, 2):
        x = _inputs(tcfg.tiny(), seed)[:n_in]
        _same(graphed(*x), eager(*x))
    assert graphed.captures == 0


@pytest.mark.parametrize("name", list(MAKERS))
def test_graphed_path_gives_the_eager_bits(weights, name, monkeypatch):
    """Through GraphCache with the emulated replay: every call (eager,
    capture, replays) the eager step's bits; an in-place load_state_dict
    keeps the graph, whose next replay reads the new weights; a new batch
    size captures again."""
    make, n_in = MAKERS[name]
    cfg = tcfg.tiny()
    model = build_cvm(cfg, "cpu", state_dict=weights[0])
    eager = make(model, cuda_graph=False)
    graphed_on_the_cpu(monkeypatch, Replayed)
    step = make(model)
    kept = []
    for seed in range(3):
        x = _inputs(cfg, seed)[:n_in]
        kept.append((x, step(*x)))
        _same(kept[-1][1], eager(*x))
    for x, out in kept:            # clones: the later calls overwrote none
        _same(out, eager(*x))
    assert step.captures == 1
    model.load_state_dict(weights[1])
    x = _inputs(cfg, 7)[:n_in]
    _same(step(*x), eager(*x))
    assert step.captures == 1
    x = _inputs(cfg, 8, b=3)[:n_in]
    for _ in range(2):
        _same(step(*x), eager(*x))
    assert step.captures == 2


@pytest.fixture(scope="module")
def jax_setup():
    """test_torch_evaluate.py's setup: tiny() JAX variables (seed 31), the
    port's model on them, the JAX decode and full-map steps, the JAX
    heatmap for the tie check."""
    cfg = jcfg.tiny()
    model = JaxCVM(cfg)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    variables = jax_variables(model, np.zeros((1, hg, wg, 3), np.float32),
                              np.zeros((1, hs, ws, 3), np.float32), False, seed=31)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    heatmap = jax.jit(lambda v, g, s: model.apply(
        v, jax_normalize(g), jax_normalize(s), False).heatmap[..., 0])
    return dict(cfg=cfg, model=model, variables=variables,
                port=build_cvm(tcfg.tiny(), "cpu", state_dict=sd),
                jax_step=jax_decode_step(model, cfg), jax_map_step=jax_eval_step(model, cfg),
                heatmap=lambda g, s: np.asarray(heatmap(variables, g, s)))


def test_eval_over_loader_graphed_equals_eager_and_jax(jax_setup, monkeypatch):
    """test_torch_evaluate.py's 360 case with prob@GT, the port's step
    graphed (emulated replay): its summary equals the eager step's to the
    bit and matches the JAX loop's within that file's tolerances."""
    cfg = jax_setup["cfg"]
    split = tev.SyntheticSplit(cfg, tev.N)
    mpp = tev.MPP.__getitem__

    def port(step):
        loader = ThreadedLoader(split, tev.BATCH, shuffle=False, drop_last=False,
                                num_workers=2)
        return evaluate.eval_over_loader(step, loader, mpp, with_prob_at_gt=True,
                                         device="cpu")

    eager = port(make_eval_decode_step(jax_setup["port"], cuda_graph=False))
    graphed_on_the_cpu(monkeypatch, Replayed)
    step = make_eval_decode_step(jax_setup["port"])
    prec = []
    got = port(tev.recording(step, prec))
    assert got == eager and step.captures == 1
    jrec = []
    want = jevaluate.eval_over_loader(
        tev.recording(jax_setup["jax_step"], jrec), jax_setup["variables"]["params"],
        jax_setup["variables"]["batch_stats"],
        JaxLoader(split, tev.BATCH, shuffle=False, drop_last=False, num_workers=2), cfg, mpp,
        with_prob_at_gt=True)
    (grd, sat), want_s = tev.per_sample([(a[2:], o) for a, o in jrec], tev.N)
    _, got_s = tev.per_sample(prec, tev.N)
    same = tev.same_peaks(got_s[0], got_s[1], want_s[0], want_s[1],
                          lambda idx: jax_setup["heatmap"](grd[idx], sat[idx]))
    for k in (3, 4):
        np.testing.assert_array_equal(got_s[k], want_s[k])
    np.testing.assert_allclose(got_s[2][same], want_s[2][same], atol=tev.ANGLE_SAMPLE_ATOL)
    np.testing.assert_allclose(got_s[5], want_s[5], atol=tev.HEATMAP_ATOL)
    tev.assert_summaries_match(tev.summary_over(pose, got_s, split, same, True),
                               tev.summary_over(tev.jpose, want_s, split, same, True))
    if same.all():
        tev.assert_summaries_match(got, want)


def _rates_off(summary):
    return {k: v for k, v in summary.items() if k not in ("fps", "aggregate_fps")}


def test_stream_eval_graphed_equals_eager_and_jax(jax_setup, monkeypatch):
    """stream_eval's default step on test_torch_stream.py's traversal:
    cuda_graph=True on the CPU and the graphed path (emulated replay) give
    the eager summary to the bit, which matches the JAX stream's within
    that file's tolerances."""
    setup = jax_setup
    traversal = tst.SyntheticTraversal(setup["cfg"], 12)

    def port(**kw):
        return stream_eval(setup["port"], tcfg.tiny(), traversal, range(tst.N),
                           batch_size=tst.BATCH, meters_per_pixel=tst.MPP, num_workers=2,
                           device="cpu", **kw)

    eager = _rates_off(port(cuda_graph=False))
    assert _rates_off(port()) == eager
    graphed_on_the_cpu(monkeypatch, Replayed)
    monkeypatch.setattr(stream, "_DECODE_STEPS", type(stream._DECODE_STEPS)())
    assert _rates_off(port()) == eager
    assert stream._DECODE_STEPS[setup["port"]].captures == 1
    want = jstream.stream_eval(setup["model"], setup["cfg"], setup["variables"]["params"],
                               setup["variables"]["batch_stats"], traversal, range(tst.N),
                               batch_size=tst.BATCH, meters_per_pixel=tst.MPP, num_workers=2,
                               eval_step=setup["jax_map_step"])
    assert eager["frames"] == want["frames"] == tst.N
    tst.assert_summaries_match({k: v for k, v in eager.items() if k != "frames"},
                               {k: v for k, v in _rates_off(want).items() if k != "frames"})


def test_stream_eval_keeps_one_step_a_model(weights, monkeypatch):
    """Two calls on one model capture once; the entry goes with the model.
    A caller's eval_step is called as given, and cuda_graph=False makes no
    entry."""
    cfg = tcfg.tiny()
    graphed_on_the_cpu(monkeypatch, stand_in_graph)
    cache = type(stream._DECODE_STEPS)()
    monkeypatch.setattr(stream, "_DECODE_STEPS", cache)
    data = SyntheticDataset(cfg, n=2 * B)
    model = build_cvm(cfg, "cpu", state_dict=weights[0])

    def run(**kw):
        return stream_eval(model, cfg, data, range(2 * B), batch_size=B, num_workers=1,
                           device="cpu", **kw)

    run(cuda_graph=False)
    assert len(cache) == 0
    run()
    run()
    assert list(cache.keys()) == [model] and cache[model].captures == 1
    calls = []
    base = make_eval_step(model, cuda_graph=False)

    def own(grd, sat):
        calls.append(grd.shape)
        return base(grd, sat)

    run(eval_step=own)
    assert len(calls) == 2 and cache[model].captures == 1
    step = cache[model]
    del model, base, own            # the eager step holds its model
    gc.collect()
    assert len(cache) == 0
    with pytest.raises(RuntimeError, match="model was dropped"):
        step(*_inputs(cfg, 0)[:2])


def test_trainer_validation_graphed_equals_eager(monkeypatch, tmp_path):
    """The Trainer's validation step, graphed (emulated replay), built once:
    after each of two epochs it equals eval_over_loader with an eager step
    on the same weights, to the bit; its graph, captured in epoch 1's
    validation, replays in epoch 2's on the weights and BN stats the train
    step changed in place. Without the patch the CPU Trainer's step is
    eager."""
    cfg = tcfg.tiny()
    train_set, val_set = SyntheticDataset(cfg, n=B), SyntheticDataset(cfg, n=2 * B, seed=100)
    tc = tcfg.TrainConfig(batch_size=B, epochs=2, log_every=1)
    assert Trainer(cfg, tc, workdir=str(tmp_path / "eager"), device="cpu").eval_step.graphs is None
    graphed_on_the_cpu(monkeypatch, Replayed)
    trainer = Trainer(cfg, tc, workdir=str(tmp_path / "graphed"), device="cpu")
    val = val_loaders(val_set, B)
    before = None
    for epoch in range(2):
        trainer.train_epoch(train_loaders(train_set, B)(epoch), epoch)
        got = trainer.validate(val(epoch), 0.1, epoch)
        eager = make_eval_decode_step(trainer.state.model, cuda_graph=False)
        assert got == evaluate.eval_over_loader(eager, val(epoch), 0.1, device="cpu"), epoch
        assert got != before and trainer.eval_step.captures == 1
        before = got
    trainer.ckpt.wait()


# --- the refusals ---

@pytest.fixture
def gloo(monkeypatch):
    """A process group whose collectives cannot be captured."""
    monkeypatch.setattr(mesh, "backend", lambda: "gloo")
    assert not mesh.capturable()


AXES = {"spatial_axis": dict(spatial_axis="model"), "ori_axis": dict(ori_axis="model")}


@pytest.mark.parametrize("axis", list(AXES))
def test_model_axis_under_gloo_refuses_to_graph(weights, monkeypatch, gloo, axis):
    cfg = dataclasses.replace(tcfg.tiny(), **AXES[axis])
    model = build_cvm(cfg, "cpu", state_dict=weights[0])
    graphed_on_the_cpu(monkeypatch, stand_in_graph)
    step = make_eval_decode_step(model)
    with mesh.set_mesh(mesh.Mesh(1, 2)):
        with pytest.raises(RuntimeError, match="cuda_graph=False"):
            step(*_inputs(cfg, 0))
    assert step.captures == 0


def test_data_axis_under_gloo_graphs(weights, monkeypatch, gloo):
    """An eval-mode forward runs no collective on the data axis (BatchNorm
    reads its running stats), so a data-parallel evaluation under gloo
    graphs; a model axis that no ModelConfig axis names does too."""
    cfg = tcfg.tiny()
    model = build_cvm(cfg, "cpu", state_dict=weights[0])
    eager = make_eval_decode_step(model, cuda_graph=False)
    graphed_on_the_cpu(monkeypatch, Replayed)
    for shape in ((2, 1), (1, 2)):
        step = make_eval_decode_step(model)
        with mesh.set_mesh(mesh.Mesh(*shape)):
            for seed in range(3):
                x = _inputs(cfg, seed)
                _same(step(*x), eager(*x))
        assert step.captures == 1, shape


def test_anomaly_mode_refuses_to_graph(weights, monkeypatch):
    model = build_cvm(tcfg.tiny(), "cpu", state_dict=weights[0])
    graphed_on_the_cpu(monkeypatch, stand_in_graph)
    step = make_eval_decode_step(model)
    with torch.autograd.set_detect_anomaly(True):
        with pytest.raises(RuntimeError, match="anomaly mode.*cuda_graph=False"):
            step(*_inputs(tcfg.tiny(), 0))
        # eager, as the Trainer makes it under NaN checks
        make_eval_decode_step(model, cuda_graph=False)(*_inputs(tcfg.tiny(), 0))
    assert step.captures == 0
