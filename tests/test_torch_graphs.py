"""The CUDA-graph plumbing as far as the CPU shows it (the graphs
themselves run only on the card: chip_smoke.py phase 14 holds graphed
serving and train steps to eager ones there, to the bit):

- core/graphs.py::Graph with a stand-in graph: a capture counts no launch
  and each replay adds the capture's; a failed capture raises and leaves
  the counters as they were;
- cuda_graph=True on a CPU InferenceEngine and train step gives today's
  eager results to the bit (the CPU path stays eager);
- the optimizer's tensor learning rate follows the float schedule, a
  checkpoint with a tensor rate restores into the CPU optimizer, and
  state_binding (when a captured step is stale) changes exactly when the
  port replaces the state's tensors;
- the engine's warmup runs the dtype it serves.

Tolerance: none; every comparison is to the bit."""

import contextlib
import copy
from unittest import mock

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core.checkpoint import CheckpointManager, load_payload, step_file
from ccvpe_tpu_torch.core.graphs import Graph, launch_counters, read_counts
from ccvpe_tpu_torch.models.cvm import CVM, random_init_
from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda
from ccvpe_tpu_torch.serve import InferenceEngine
from ccvpe_tpu_torch.train.step import (Batch, create_train_state, make_optimizer,
                                        make_train_step, state_binding, warmup_cosine)

SCHEDULE = tcfg.TrainConfig(learning_rate=1e-2, schedule="warmup_cosine", warmup_steps=3,
                            total_steps=10)


class StandIn:
    """What Graph asks of a torch.cuda.CUDAGraph, counted."""

    def __init__(self):
        self.replays, self.generators = 0, []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


def stand_in_graph():
    return Graph(StandIn(), context=lambda graph: contextlib.nullcontext())


def launch(corr=0, lmu_fwd_bf16=0, lmu_bwd=0):
    """What the wrappers do on the host where they launch."""
    corr_cuda.corr_core.launches += corr
    lmu_cuda.fused_stage.bf16_launches += lmu_fwd_bf16
    lmu_cuda.fused_stage_bwd.launches += lmu_bwd


def test_counters_name_every_wrapper():
    assert {(fn.__name__, attr) for fn, attr in launch_counters()} == {
        (name, attr) for name in ("corr_core", "fused_stage", "fused_stage_bwd")
        for attr in ("launches", "bf16_launches")}


def test_capture_counts_nothing_and_each_replay_counts_the_capture():
    graph = stand_in_graph()
    gen = torch.Generator()
    before = read_counts()
    assert graph.capture(lambda: launch(6, 2, 4) or "out", generators=[gen]) == "out"
    assert read_counts() == before
    assert graph.cuda_graph.generators == [gen]
    for _ in range(3):
        graph.replay()
    assert graph.cuda_graph.replays == 3
    delta = [a - b for a, b in zip(read_counts(), before)]
    assert delta == [18, 0, 0, 6, 12, 0]


def test_failed_capture_raises_and_restores_the_counters():
    graph = stand_in_graph()
    before = read_counts()

    def fails():
        launch(6)
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graph.capture(fails)
    assert read_counts() == before
    with pytest.raises(RuntimeError, match="replay before capture"):
        graph.replay()


@pytest.fixture(scope="module")
def tiny_weights():
    return random_init_(CVM(tcfg.tiny()).to_empty(device="cpu"),
                        torch.Generator().manual_seed(5)).state_dict()


def test_engine_cuda_graph_on_the_cpu_is_eager(tiny_weights):
    cfg = tcfg.tiny()
    rng = np.random.default_rng(3)
    grd = rng.integers(0, 256, (3, *cfg.grd_size, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (3, *cfg.sat_size, 3), dtype=np.uint8)
    out = {}
    for flag in (False, True):
        engine = InferenceEngine(cfg, tiny_weights, batch_size=2, device="cpu", cuda_graph=flag)
        out[flag] = engine.predict(grd, sat) + engine.predict(grd[:2], sat[:2])
        assert not engine.cuda_graph and engine.captures == 0
    assert out[True] == out[False]
    assert all(isinstance(p.row, int) and isinstance(p.angle_deg, float) for p in out[True])


def test_engine_warmup_runs_the_served_dtype(tiny_weights):
    """Graphs are keyed on the input dtype, so warmup runs the dtype that
    traffic sends: uint8 by default, as the loaders send it."""
    engine = InferenceEngine(tcfg.tiny(), tiny_weights, batch_size=2, device="cpu")
    with mock.patch.object(engine, "_run", wraps=engine._run) as spy:
        engine.warmup()
        engine.warmup(np.float32)
    assert [tuple(a.dtype for a in c.args) for c in spy.call_args_list] == [
        (np.dtype(np.uint8),) * 2, (np.dtype(np.float32),) * 2]


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return Batch(rng.integers(0, 256, (b, *cfg.grd_size, 3), dtype=np.uint8),
                 rng.integers(0, 256, (b, *cfg.sat_size, 3), dtype=np.uint8),
                 rng.uniform(-30, 30, b).astype(np.float32),
                 rng.uniform(-30, 30, b).astype(np.float32),
                 rng.uniform(0, 360, b).astype(np.float32))


def test_train_step_cuda_graph_on_the_cpu_is_eager(tiny_weights):
    cfg = tcfg.tiny()
    runs = {}
    for flag in (False, True):
        state = create_train_state(cfg, SCHEDULE, device="cpu", state_dict=tiny_weights)
        step = make_train_step(cfg, SCHEDULE, cuda_graph=flag)
        gen = torch.Generator()
        metrics = []
        for i in range(2):
            gen.manual_seed(11 + i)
            state, m = step(state, _batch(cfg, 2, i), gen)
            metrics.append({k: v.item() for k, v in m.items()})
        assert step.captures == 0 and state.step == 2 and state.optimizer.count == 2
        runs[flag] = (metrics, state)
    assert runs[True][0] == runs[False][0]
    for (k, a), b in zip(runs[True][1].model.state_dict().items(),
                         runs[False][1].model.state_dict().values()):
        assert torch.equal(a, b), k


def test_cpu_optimizer_keeps_a_float_rate():
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(3))], SCHEDULE)
    assert not opt.capturable
    assert all(isinstance(g["lr"], float) and not g["capturable"] for g in opt.opt.param_groups)


def test_tensor_rate_follows_the_float_schedule():
    """The card's form: the rate a tensor the schedule fills in place."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([p], SCHEDULE)
    rate = torch.tensor(opt.opt.param_groups[0]["lr"], dtype=torch.float32)
    opt.opt.param_groups[0]["lr"] = rate
    lr = warmup_cosine(SCHEDULE.learning_rate, SCHEDULE.warmup_steps, SCHEDULE.total_steps)
    for count in range(1, 13):
        opt.advance()
        assert opt.opt.param_groups[0]["lr"] is rate
        assert rate.item() == np.float32(lr(count)), count
    assert opt.count == 12


def _stepped(seed, steps=2):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = make_optimizer(model.parameters(), SCHEDULE)
    x = torch.randn(5, 4)
    for _ in range(steps):
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()
    return model, opt


def test_state_dict_with_a_tensor_rate_restores_into_the_cpu_optimizer():
    """A state_dict saved on the card (capturable, rate a tensor, step
    counts float32 tensors) loads into the CPU optimizer's own form, and
    both go on to the same update."""
    model, opt = _stepped(1)
    card = copy.deepcopy(opt.opt.state_dict())
    for g in card["param_groups"]:
        g["lr"], g["capturable"] = torch.tensor(g["lr"], dtype=torch.float32), True
    for st in card["state"].values():
        st["step"] = st["step"].to(torch.float32)
    model2, fresh = _stepped(9, steps=0)
    model2.load_state_dict(model.state_dict())
    fresh.load_state_dict(card)
    fresh.count = opt.count
    for g, want in zip(fresh.opt.param_groups, opt.opt.param_groups):
        assert isinstance(g["lr"], float) and g["lr"] == float(np.float32(want["lr"]))
        assert g["capturable"] is False
    x = torch.randn(5, 4)
    for m, o in ((model, opt), (model2, fresh)):
        o.opt.param_groups[0]["lr"] = float(np.float32(o.opt.param_groups[0]["lr"]))
        o.zero_grad()
        m(x).square().sum().backward()
        o.step()
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_saves_a_float_rate(tmp_path):
    model, opt = _stepped(2)
    want = opt.opt.param_groups[0]["lr"]
    opt.opt.param_groups[0]["lr"] = torch.tensor(want, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, type("S", (), dict(step=2, model=model, optimizer=opt))())
    mgr.wait()
    lr = load_payload(step_file(str(tmp_path), 2))["optimizer"]["param_groups"][0]["lr"]
    assert isinstance(lr, float) and lr == float(np.float32(want))


def test_state_binding_changes_when_the_state_is_replaced(tiny_weights):
    cfg = tcfg.tiny()
    state = create_train_state(cfg, SCHEDULE, device="cpu", state_dict=tiny_weights)
    step = make_train_step(cfg, SCHEDULE)
    gen = torch.Generator().manual_seed(1)
    step(state, _batch(cfg, 2, 0), gen)
    bound = state_binding(state, gen)
    assert state_binding(state, gen) == bound
    # a model load_state_dict copies into the same tensors: the graph holds
    state.model.load_state_dict({k: v.clone() for k, v in state.model.state_dict().items()})
    assert state_binding(state, gen) == bound
    assert state_binding(state, torch.Generator()) != bound
    other = create_train_state(cfg, SCHEDULE, device="cpu", state_dict=tiny_weights)
    assert state_binding(other, gen) != bound
    # an optimizer restore replaces Adam's tensors: capture again
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    assert state_binding(state, gen) != bound
