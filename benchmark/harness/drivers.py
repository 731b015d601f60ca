"""The drivers of the traffic kinds: set-up, the measured window and the
check of what the window produced, for a train step ("train") and for an
inference engine under a closed loop of one client ("serve"). The program
under test is ccvpe_tpu_torch; these are its entry points as a user calls
them: `make_train_step(..., cuda_graph=True)` with its state, and
`InferenceEngine.predict`.

Set-up builds the program's objects from the seed's weights (made by the
benchmark on the device, reference/train.py::make_params) and warms the
cell's own shape up: a train step runs its first three steps (eager,
captured, replayed), which the check compares with the reference; an
engine runs `warmup()` and one request. Nothing compiles in the window."""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

from harness import check, traffic
from reference import train as rtrain
from reference.seeds import derive

STEPS_CHECKED = 3
IN_FLIGHT = 2        # train steps queued on the device at most


def model_config(model: dict):
    from ccvpe_tpu_torch.core.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})


def _range(name: str):
    return torch.autograd.profiler.record_function(name)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _first_grad_norm(adam_state: dict, beta1: float) -> float:
    """The first gradient's norm as Adam holds it after one step (its first
    moment over 1 - beta1); 0 where Adam holds nothing for the leaf."""
    m = adam_state.get("exp_avg")
    return 0.0 if m is None else float(torch.linalg.vector_norm(m) / (1 - beta1))


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)

    def make_pool(self) -> None:
        self.pool = traffic.pool(self.cell.traffic, self.cell.model, self.seed, self.device)


class Train(Driver):
    """A train step driven once a batch, cycling through the pool."""

    prog: Optional[dict] = None

    def setup(self) -> None:
        from ccvpe_tpu_torch.core.config import TrainConfig
        from ccvpe_tpu_torch.train.step import create_train_state, make_train_step
        c = self.cell
        self.make_pool()
        tc = TrainConfig(**c.config["train"])
        params = rtrain.make_params(c.model, self.seed, self.device)
        self.state = create_train_state(model_config(c.model), tc, device=self.device,
                                        state_dict=params)
        del params
        self.step = make_train_step(model_config(c.model), tc, cuda_graph=True)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(derive(self.seed, "dropconnect"))
        named = list(self.state.model.named_parameters())
        start = {n: p.detach().to("cpu", copy=True) for n, p in named}
        losses, grads = [], None
        for i in range(STEPS_CHECKED):
            self.state, metrics = self.step(self.state, self.pool[i], self.gen)
            losses.append(float(metrics["loss"]))
            if i == 0:
                opt = self.state.optimizer.opt
                beta1 = opt.param_groups[0]["betas"][0]
                grads = {n: _first_grad_norm(opt.state.get(p, {}), beta1) for n, p in named}
        change = {n: float(torch.linalg.vector_norm(p.detach().cpu() - start[n]))
                  for n, p in named}
        self.prog = {"losses": losses, "grad_norms": grads, "change_norms": change}
        self.next = STEPS_CHECKED
        _sync(self.device)

    def window(self, seconds: float) -> dict:
        queued = collections.deque()
        n, cuda = 0, self.device.type == "cuda"
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with _range("bench.step"):
                self.state, _ = self.step(self.state, self.pool[self.next % len(self.pool)],
                                          self.gen)
            self.next += 1
            n += 1
            if cuda:
                queued.append(torch.cuda.Event())
                queued[-1].record()
                if len(queued) > IN_FLIGHT:
                    queued.popleft().synchronize()
        _sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"steps": n, "window_s": elapsed,
                "train_pairs_per_s": n * self.cell.traffic["batch"] / elapsed}

    def free(self) -> None:
        del self.state, self.step, self.gen

    def check(self, stand_in: Optional[dict] = None) -> dict:
        """The program's first steps against the reference's; `stand_in`
        (reference_train's options: tf32, half_batch) puts the reference so
        computed in the program's place (a control, a planted fault)."""
        c = self.cell
        ref = check.reference_train(c.model, c.config["train"], self.seed,
                                    self.pool[:STEPS_CHECKED], self.device)
        prog = self.prog if stand_in is None else check.reference_train(
            c.model, c.config["train"], self.seed, self.pool[:STEPS_CHECKED], self.device,
            **stand_in)
        numbers = check.train_numbers(prog, ref)
        return {"numbers": numbers, "detail": check.train_detail(prog, ref),
                "failed": 0 if check.verdict(numbers, c.limits) else STEPS_CHECKED}


class Serve(Driver):
    """A closed loop of one client: each request is `predict` on the next
    batch of the pool, sent when the last one returned."""

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.answers: Dict[int, List[torch.Tensor]] = collections.defaultdict(list)

    def setup(self) -> None:
        from ccvpe_tpu_torch.serve import InferenceEngine
        c = self.cell
        self.make_pool()
        self.host = [(b.grd.numpy(), b.sat.numpy()) for b in self.pool]
        params = rtrain.make_params(c.model, self.seed, self.device)
        self.engine = InferenceEngine(model_config(c.model), params,
                                      batch_size=c.traffic["batch"], device=self.device)
        del params
        self.engine.warmup()
        self.engine.predict(*self.host[0])
        _sync(self.device)

    def window(self, seconds: float) -> dict:
        lat: List[float] = []
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = n % len(self.host)
            with _range("bench.request"):
                t = time.perf_counter()
                poses = self.engine.predict(*self.host[i])
                lat.append(time.perf_counter() - t)
            self.answers[i].append(torch.tensor(
                [[p.row, p.col, p.angle_deg, p.probability] for p in poses], dtype=torch.float64))
            n += 1
        elapsed = time.perf_counter() - t0
        lat_ms = torch.tensor(lat, dtype=torch.float64) * 1e3
        return {"steps": n, "window_s": elapsed,
                "serve_pairs_per_s": n * self.cell.traffic["batch"] / elapsed,
                "serve_p95_ms": float(torch.quantile(lat_ms, 0.95))}

    def free(self) -> None:
        del self.engine

    def check(self, stand_in: Optional[dict] = None) -> dict:
        """Every answer of the window against the reference; `stand_in`
        (reference_answers' options: tf32) puts the reference's own answers
        to every pool batch in the program's place (a control)."""
        c = self.cell
        params = rtrain.make_params(c.model, self.seed, self.device)
        answers = self.answers
        if stand_in is not None:
            answers = check.reference_answers(c.model, params, self.pool, self.device, **stand_in)
        worst, per_request = check.serve_numbers(c.model, params, self.pool, answers, self.device)
        return {"numbers": worst,
                "failed": sum(not check.verdict(r, c.limits) for r in per_request)}


DRIVERS = {"train": Train, "serve": Serve}


@contextlib.contextmanager
def window_range(trace: bool):
    """The profiler over the window, with its range, or nothing."""
    if not trace:
        yield None
        return
    from harness.trace import WINDOW_RANGE, profiler
    with profiler() as prof:
        with _range(WINDOW_RANGE):
            yield prof
