"""The port's tracing (core/profiling.py) as far as the CPU shows it:

- span is one shared no-op context while no profiler records, and makes
  no range object; under torch.profiler the engine's and the train step's
  spans nest under their root;
- counters() holds the process's counts, every kernel launch counter of
  core/graphs.py and launches.resize, as the wrappers register them;
  count() loses no update across threads;
- the device layer marks (recorded in place of their launches): a served
  batch, an eval step and a train step mark their layers in order and in
  pairs; no mark outside marking(), and none in export_program's program;
  csrc/marks.cu's marks are MARKS, in order;
- the eval loop's spans, the loader's spans on its threads;
- trace()'s Chrome file holds the engine's ranges.

Tolerance: none; every comparison is exact."""

import glob
import json
import os
import re
import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core import graphs, profiling
from ccvpe_tpu_torch.core.profiling import counters, mark, marking, recording_marks, span
from ccvpe_tpu_torch.data.loader import ThreadedLoader
from ccvpe_tpu_torch.models.cvm import CVM, random_init_
from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda, resize_cuda
from ccvpe_tpu_torch.serve import InferenceEngine, export_program
from ccvpe_tpu_torch.train.evaluate import pipelined
from ccvpe_tpu_torch.train.step import (Batch, create_train_state, make_eval_decode_step,
                                        make_train_step)

FORWARD = ["encoders_begin", "encoders_end", "decode_begin", "decode_end"]
STEP = ["encoders_begin", "encoders_end", "backward_begin", "backward_end",
        "optimizer_begin", "optimizer_end"]


@pytest.fixture(scope="module")
def tiny_weights():
    return random_init_(CVM(tcfg.tiny()).to_empty(device="cpu"),
                        torch.Generator().manual_seed(5)).state_dict()


def images(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *cfg.grd_size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, *cfg.sat_size, 3), dtype=np.uint8))


def host_ranges(prof):
    """(name, start ns, end ns, thread) of every ccvpe.* range."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("ccvpe.")]


def children(ranges, root):
    """The ranges inside `root` on its thread, by name, in order."""
    _, s, e, tid = root
    return [r[0] for r in sorted(ranges, key=lambda r: r[1])
            if r is not root and r[3] == tid and s <= r[1] and r[2] <= e]


def delta(before):
    after = counters()
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_span_without_a_profiler_is_the_shared_no_op():
    with mock.patch.object(torch.autograd.profiler, "record_function") as rf, \
            mock.patch.object(torch._C._profiler, "_RecordFunctionFast") as fast:
        a, b = span("engine.predict"), span("train.stage")
        with a:
            pass
    assert a is b
    assert not rf.called and not fast.called


def test_engine_spans_nest_under_the_request(tiny_weights):
    cfg = tcfg.tiny()
    engine = InferenceEngine(cfg, tiny_weights, batch_size=2, device="cpu")
    grd, sat = images(cfg, 3)
    engine.predict(grd[:1], sat[:1])
    before = counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.predict(grd, sat)
    ranges = host_ranges(prof)
    roots = [r for r in ranges if r[0] == "ccvpe.engine.predict"]
    assert len(roots) == 1
    per_batch = ["ccvpe.engine.pad", "ccvpe.engine.eager", "ccvpe.engine.fetch",
                 "ccvpe.engine.results"]
    assert children(ranges, roots[0]) == per_batch * 2
    assert delta(before) == {"engine.batches": 2}


def _batch(cfg, b, seed):
    grd, sat = images(cfg, b, seed)
    rng = np.random.default_rng(seed)
    return Batch(grd, sat, rng.uniform(-30, 30, b).astype(np.float32),
                 rng.uniform(-30, 30, b).astype(np.float32),
                 rng.uniform(0, 360, b).astype(np.float32))


def test_train_step_spans_nest_under_the_step(tiny_weights):
    cfg = tcfg.tiny()
    state = create_train_state(cfg, tcfg.TrainConfig(), device="cpu", state_dict=tiny_weights)
    step = make_train_step(cfg, tcfg.TrainConfig())
    gen = torch.Generator().manual_seed(1)
    state, _ = step(state, _batch(cfg, 2, 0), gen)
    before = counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, _batch(cfg, 2, 1), gen)
    ranges = host_ranges(prof)
    roots = [r for r in ranges if r[0] == "ccvpe.train.step"]
    assert len(roots) == 1
    assert children(ranges, roots[0]) == ["ccvpe.train.eager"]
    assert delta(before) == {"train.steps": 1}


def test_counters_report_every_launch_counter_and_the_resize():
    """Every counter of core/graphs.py's replay bookkeeping, and the
    resize's, which no graph captures, each under its own name and moving
    with its wrapper's attribute."""
    names = {"launches.corr": (corr_cuda.corr_core, "launches"),
             "launches.corr.bf16": (corr_cuda.corr_core, "bf16_launches"),
             "launches.lmu_fwd": (lmu_cuda.fused_stage, "launches"),
             "launches.lmu_fwd.bf16": (lmu_cuda.fused_stage, "bf16_launches"),
             "launches.lmu_bwd": (lmu_cuda.fused_stage_bwd, "launches"),
             "launches.lmu_bwd.bf16": (lmu_cuda.fused_stage_bwd, "bf16_launches"),
             "launches.resize": (resize_cuda.resize, "launches")}
    assert set(graphs.launch_counters()) == set(names.values()) - {(resize_cuda.resize,
                                                                    "launches")}
    assert {k for k in counters() if k.startswith("launches.")} == set(names)
    for name, (fn, attr) in names.items():
        before = getattr(fn, attr)
        try:
            setattr(fn, attr, before + 5)
            assert counters()[name] == before + 5
        finally:
            setattr(fn, attr, before)


def test_register_launches_reports_a_new_counter():
    def kernel():
        pass

    kernel.launches = 3
    profiling.register_launches("test.kernel", kernel)
    try:
        assert counters()["launches.test.kernel"] == 3
        kernel.launches += 1
        assert counters()["launches.test.kernel"] == 4
    finally:
        del profiling._launches["launches.test.kernel"]
    assert "launches.test.kernel" not in counters()


def test_count_loses_no_update_across_threads():
    interval = sys.getswitchinterval()
    name = "test.threads"
    before = counters().get(name, 0)
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count(name) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counters()[name] - before == 16 * 2000


def test_engine_marks_its_layers_in_order(tiny_weights):
    cfg = tcfg.tiny()
    engine = InferenceEngine(cfg, tiny_weights, batch_size=2, device="cpu")
    with recording_marks() as marks:
        engine.predict(*images(cfg, 3))
    assert marks == FORWARD * 2


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_marks_its_layers_in_order(tiny_weights, accum):
    cfg = tcfg.tiny()
    tc = tcfg.TrainConfig(grad_accum_steps=accum)
    state = create_train_state(cfg, tc, device="cpu", state_dict=tiny_weights)
    with recording_marks() as marks:
        make_train_step(cfg, tc)(state, _batch(cfg, 2, 0), torch.Generator().manual_seed(1))
    forward_backward = STEP[:4] * accum
    assert marks == forward_backward + STEP[4:]


def test_eval_step_marks_the_encoders(tiny_weights):
    cfg = tcfg.tiny()
    model = random_init_(CVM(cfg).to_empty(device="cpu"), torch.Generator().manual_seed(5))
    step = make_eval_decode_step(model)
    grd, sat = images(cfg, 2)
    with recording_marks() as marks:
        step(torch.from_numpy(grd), torch.from_numpy(sat), torch.zeros(2), torch.zeros(2))
    assert marks == FORWARD[:2]


def test_no_mark_outside_marking(tiny_weights):
    cfg = tcfg.tiny()
    model = random_init_(CVM(cfg).to_empty(device="cpu"), torch.Generator().manual_seed(5))
    grd, sat = images(cfg, 1)
    with recording_marks() as marks, torch.no_grad():
        model.eval()(torch.from_numpy(grd).float(), torch.from_numpy(sat).float())
        mark("decode_begin")
    assert marks == []
    with recording_marks() as marks, marking("cpu"):
        mark("decode_begin")
    assert marks == ["decode_begin"]
    with pytest.raises(KeyError):
        mark("decoders_begin")


def test_export_program_holds_no_mark(tiny_weights):
    with recording_marks() as marks:
        blob = export_program(tcfg.tiny(), tiny_weights, batch_size=1, device="cpu")
    assert marks == []
    import io
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not any("mark" in t for t in targets)


def test_the_library_marks_are_the_module_marks():
    """csrc/marks.cu's CCVPE_MARKS table, which the loader checks on the
    card, read from the source: the same names in the same order, none
    holding a name the benchmark's rooflines match on."""
    src = open(os.path.join(os.path.dirname(profiling.__file__), "..", "csrc", "marks.cu")).read()
    table = src[src.index("#define CCVPE_MARKS(X)"):]
    table = table[:table.index("\n\n")]
    entries = re.findall(r"X\((\d+), (\w+)\)", table)
    assert [int(i) for i, _ in entries] == list(range(len(profiling.MARKS)))
    assert tuple(name for _, name in entries) == profiling.MARKS
    for name in profiling.MARKS:
        assert not any(k in "ccvpe_mark_" + name for k in (
            "corr_fwd_kernel", "corr_reduce_kernel", "lmu_fwd_kernel", "lmu_bwd_kernel",
            "lmu_reduce_kernel"))


def test_eval_loop_spans_and_counts():
    def step(a):
        return (a * 2,)

    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    before = counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = list(pipelined(step, batches, lambda raw: (raw["x"],), 2, torch.device("cpu"), 2))
    assert [o[0][0][0, 0] for o in out] == [0, 2, 4]
    names = [r[0] for r in sorted(host_ranges(prof), key=lambda r: r[1])]
    assert names.count("ccvpe.eval.dispatch") == 3 and names.count("ccvpe.eval.collect") == 3
    assert delta(before) == {}      # the loop counts nothing; its step's graphs count


def test_loader_fetch_spans_on_its_threads(tmp_path):
    """trace() records the worker threads' spans too."""
    class Data:
        def __len__(self):
            return 8

        def __getitem__(self, i, rng=None):
            return {"x": np.full(2, i)}

    loader = ThreadedLoader(Data(), batch_size=2, shuffle=False, num_workers=2)
    with profiling.trace(str(tmp_path)), span("test.consumer"):
        assert len(list(loader)) == 4
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (consumer,) = [e["tid"] for e in events if e.get("name") == "ccvpe.test.consumer"]
    fetches = [e["tid"] for e in events if e.get("name") == "ccvpe.loader.fetch"]
    assert len(fetches) == 8 and consumer not in fetches


def test_trace_writes_the_engine_ranges(tiny_weights, tmp_path):
    cfg = tcfg.tiny()
    engine = InferenceEngine(cfg, tiny_weights, batch_size=2, device="cpu")
    with profiling.trace(str(tmp_path)):
        engine.predict(*images(cfg, 2))
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"ccvpe.engine.predict", "ccvpe.engine.pad", "ccvpe.engine.eager",
            "ccvpe.engine.fetch", "ccvpe.engine.results"} <= names
