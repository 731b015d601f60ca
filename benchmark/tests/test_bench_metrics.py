"""Each per-layer metric's arithmetic on synthetic trace events: the union
of spans, the idle gaps by host activity, the attribution by kernel name,
and the work counts against shapes worked by hand."""

import pytest

from harness import peaks, roofline, spec, trace
from work import corr, lmu_bwd, lmu_fwd, lmu_stage

US = 1000


def window(device, host=(), span=(0, 100 * US), steps=1, cell=None):
    return trace.window(list(device), list(host), span, steps, cell)


def test_union_of_spans_and_idle():
    # two kernels side by side (a graph's branches), a copy, a gap of 40 us
    w = window([("k1", 0, 30 * US), ("k2", 10 * US, 40 * US), ("Memcpy", 80 * US, 90 * US)],
               host=[("aten::copy_", 45 * US, 75 * US), ("bench.window", 0, 100 * US)])
    assert w.busy_s == pytest.approx(50e-6) and w.window_s == pytest.approx(100e-6)
    idle = spec.metric_reader("device_idle.train").read(w)
    assert idle == pytest.approx(50.0)
    # the 40 us gap is the host's copy; the 10 us tail is a launch gap
    assert w.gaps["aten::copy_"] == pytest.approx(40e-6)
    assert w.gaps[trace.LAUNCH_GAPS] == pytest.approx(10e-6)


def test_events_outside_the_window_are_clipped():
    w = window([("k", -50 * US, 20 * US), ("k", 90 * US, 150 * US)])
    assert w.busy_s == pytest.approx(30e-6)


def test_attribution_by_kernel_name():
    w = window([("void (anonymous namespace)::corr_fwd_kernel<4, float, false>(...)", 0, 3),
                ("corr_reduce_kernel(float const*)", 3, 5), ("lmu_fwd_kernel<512, float>", 5, 9),
                ("lmu_fwd_bf16_kernel<...>", 9, 20)])
    secs, launches = w.kernel_seconds(("corr_fwd_kernel", "corr_reduce_kernel"))
    assert secs == pytest.approx(5e-9) and launches == {"corr_fwd_kernel": 1,
                                                        "corr_reduce_kernel": 1}
    secs, launches = w.kernel_seconds(("lmu_fwd_kernel",))
    assert secs == pytest.approx(4e-9) and launches == {"lmu_fwd_kernel": 1}


VIGOR = spec.read_json(spec.BENCH / "configs" / "vigor.json")["model"]
TRAIN = {"kind": "train", "batch": 8}
SERVE = {"kind": "serve", "batch": 8}


def test_corr_work_by_hand():
    # VIGOR's six scales: N = (8 * 2^s)^2, D = 1280 then the loc convs,
    # L = 20 ground columns x the head's channels, K = 20
    assert corr.scales(VIGOR, 8) == [(8, 64, 1280, 1280, 20), (8, 256, 640, 640, 20),
                                     (8, 1024, 320, 320, 20), (8, 4096, 160, 160, 20),
                                     (8, 16384, 80, 80, 20), (8, 65536, 40, 40, 20)]
    f, b = corr.calls(VIGOR, SERVE)[0]
    assert f == 4 * 8 * 64 * 20 * 1280 + 8 * 64 * 1280
    assert b == 4 * (8 * 64 * 1280 + 8 * 1280 + 8 * 64 * 20)


def test_lmu_work_by_hand():
    assert lmu_stage.stages(VIGOR, 8) == [(8, 128, 128, 81, 16, 40, 40, 40),
                                          (8, 256, 256, 41, 0, 16, 16, 1),
                                          (8, 128, 128, 64, 16, 32, 32, 32),
                                          (8, 256, 256, 32, 0, 16, 16, 2)]
    p = 8 * 256 * 256
    f, b = lmu_fwd.calls(VIGOR, SERVE)[0]
    assert f == 2 * p * (81 * 40 + 9 * 56 * 40 + 9 * 40 * 40)
    wts = 4 * 81 * 40 + 40 + 9 * 56 * 40 + 40 + 9 * 40 * 40 + 40
    assert b == 4 * (8 * 128 * 128 * 81 + p * 16 + wts + p * 40)
    f, b = lmu_bwd.calls(VIGOR, TRAIN)[0]
    assert f == 4 * p * (9 * 40 * 40 + 9 * 40 * 56 + 40 * 81)
    assert lmu_bwd.calls(VIGOR, SERVE) == []
    assert lmu_stage.stages(dict(VIGOR, lmu_fused_min_res=0), 8) == []


class Cell:
    def __init__(self, model, traffic, train=None):
        self.model, self.traffic, self.config = model, traffic, {"train": train or {}}


def test_roofline_share_and_call_count():
    cell = Cell(VIGOR, SERVE)
    least = roofline.least_seconds(corr.calls(VIGOR, SERVE), VIGOR)
    kernels = [("corr_fwd_kernel<4, float, false>", i * 1000, i * 1000 + 400) for i in range(12)]
    w = window(kernels, span=(0, 10 ** 9), steps=2, cell=cell)
    share = spec.metric_reader("corr_roofline.serve").read(w)
    assert share == pytest.approx(100 * least * 2 / (12 * 400e-9))
    short = window(kernels[:11], span=(0, 10 ** 9), steps=2, cell=cell)
    assert spec.metric_reader("corr_roofline.serve").read(short) is None


def test_step_mfu_arithmetic(monkeypatch):
    from work import model
    monkeypatch.setattr(model, "step_flops", lambda m, t, tr: 4.95e12)
    w = window([], span=(0, 2 * 10 ** 9), steps=10, cell=Cell(VIGOR, TRAIN))
    assert spec.metric_reader("step_mfu.train").read(w) == pytest.approx(
        100 * 4.95e12 * 10 / (2 * peaks.TF32_FLOPS_PER_S))


def test_model_flops_count_the_function():
    """Forward FLOPs of a tiny model by hand for one conv, and the backward
    of a depthwise conv counted as twice its forward (FlopCounterMode's own
    formula counts it as dense)."""
    from work import model
    fwd = model.conv_backward([2, 8, 4, 4], [2, 8, 4, 4], [8, 1, 3, 3], None, None, None, None,
                              False, None, 8, [True, True])
    assert fwd == 2 * 2 * (2 * 4 * 4 * 8 * 9)
    tconv = model.conv_backward([2, 4, 8, 8], [2, 6, 4, 4], [6, 4, 2, 2], None, None, None,
                                None, True, None, 1, [False, True])
    assert tconv == 2 * (2 * 4 * 4 * 6 * 4 * 4)
