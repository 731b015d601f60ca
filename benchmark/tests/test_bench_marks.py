"""The readers of the program's device layer marks (harness/marks.py;
metrics encoders_ms.train, backward_ms.train, optimizer_ms.train) on synthetic
trace events: the median of the marked spans, pairs cut by the window's
ends, None for a program that launches no marks (an older one), and the
accepted readers' values with mark kernels among the kernels."""

import pytest

from harness import marks, spec, trace
from work import corr, lmu_bwd, lmu_fwd

US = 1000
MARK_READERS = {"encoders_ms.train": "train", "backward_ms.train": "train",
                "optimizer_ms.train": "train"}


def window(device, span=(0, 10 ** 9), steps=1, cell=None):
    return trace.window(list(device), [], span, steps, cell)


def marked(layer, start, length, mark=2 * US):
    """A begin mark at `start`, the layer's `length`, then its end mark."""
    return [(f"ccvpe_mark_{layer}_begin", start, start + mark),
            (f"ccvpe_mark_{layer}_end", start + mark + length, start + 2 * mark + length)]


def test_spans_pair_each_begin_with_the_next_end():
    w = window(marked("encoders", 0, 10 * US) + marked("encoders", 100 * US, 30 * US)
               + marked("encoders", 200 * US, 20 * US) + marked("backward", 300 * US, 5 * US))
    assert marks.spans(w, "encoders") == pytest.approx([10e-6, 30e-6, 20e-6])
    assert marks.median_ms(w, "encoders") == pytest.approx(20e-3)
    assert marks.median_ms(w, "backward") == pytest.approx(5e-3)


def test_a_pair_cut_by_the_window_is_left_out():
    events = (marked("optimizer", 0, 10 * US) + marked("optimizer", 100 * US, 40 * US)
              + marked("optimizer", 200 * US, 10 * US))
    # the first begin lies before the window, the last end after it
    w = window(events, span=(3 * US, 211 * US))
    assert marks.spans(w, "optimizer") == pytest.approx([40e-6])


@pytest.mark.parametrize("name", sorted(MARK_READERS))
def test_each_reader_reads_its_layer(name):
    layer = name.split("_ms.")[0]
    events = []
    for i, ms in enumerate((7, 9, 8)):
        events += marked(layer, i * 10 ** 8, ms * 10 ** 6)
        events += marked("decode", i * 10 ** 8 + 5 * 10 ** 7, 10 ** 6)   # another layer
    reader = spec.metric_reader(name)
    assert reader.KIND == MARK_READERS[name]
    assert reader.read(window(events, steps=3)) == pytest.approx(8.0)


@pytest.mark.parametrize("name", sorted(MARK_READERS))
def test_no_marks_read_none(name):
    """A program without marks (the parent) prints no value."""
    w = window([("corr_fwd_kernel<4, float, false>", 0, 400), ("lmu_fwd_kernel<512>", 500, 900)])
    assert spec.metric_reader(name).read(w) is None


def _steps(cell, calls, n):
    """n steps' kernels: each call of each kernel a step, 400 ns each, 10 us apart."""
    out, t = [], 0
    for _ in range(n):
        for kernel, count in calls:
            for _ in range(count):
                out.append((kernel, t, t + 400))
                t += 10 * US
    return out


@pytest.mark.parametrize("kind,readers", [
    ("serve", ("device_idle.serve", "step_mfu.serve", "corr_roofline.serve",
               "lmu_fwd_roofline.serve")),
    ("train", ("device_idle.train", "step_mfu.train", "corr_roofline.train",
               "lmu_bwd_roofline.train"))])
def test_accepted_readers_read_the_same_beside_marks(kind, readers, monkeypatch):
    """The accepted readers give the same values with the marks' kernels
    among the window's kernels, but the idle share, which counts the marks'
    2 us each as busy."""
    from work import model
    monkeypatch.setattr(model, "step_flops", lambda m, t, tr: 4.95e12)
    cell = spec.cell(f"vigor-{kind}-b8")
    lmu = (("lmu_fwd_kernel<512>", len(lmu_fwd.calls(cell.model, cell.traffic))) if kind == "serve"
           else ("lmu_bwd_kernel<512, 8>", len(lmu_bwd.calls(cell.model, cell.traffic))))
    calls = [("corr_fwd_kernel<4, float, false>", len(corr.calls(cell.model, cell.traffic))), lmu]
    steps = 3
    plain = _steps(cell, calls, steps)
    end = plain[-1][2]
    layers = ("encoders", "decode") if kind == "serve" else ("encoders", "backward", "optimizer")
    extra = [m for i in range(steps) for j, layer in enumerate(layers)
             for m in marked(layer, end + (i * 10 + j) * 100 * US, 50 * US)]
    span = (0, end + 40 * 100 * US)
    a = window(plain, span, steps, cell)
    b = window(plain + extra, span, steps, cell)
    for name in readers:
        reader = spec.metric_reader(name)
        if name.startswith("device_idle"):
            added = sum(e - s for _, s, e in extra) / 1e9
            assert reader.read(b) == pytest.approx(reader.read(a) - 100 * added / a.window_s)
        else:
            assert reader.read(a) is not None
            assert reader.read(b) == pytest.approx(reader.read(a))


LAYERS = {"serve": ("encoders", "decode"),
          "train": ("encoders", "backward", "optimizer")}


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_one_pair_of_each_layer_a_step_on_the_card(name, card):
    """A traced window of the cell at tiny widths on the card: the program's
    marks come, in its replays, as one pair of each layer a step or request,
    the layers one after another, from the window's first step on. The
    card's trace may end inside the window's last steps (the last 0 to 6
    of ~130 requests, every kernel of them alike: B1's too), so the marks
    are held to the steps whose B1 kernels the trace holds, and may stop
    inside a step; at tiny widths a marked span holds the graph's launch
    gaps between its kernels, so it is not held to the busy time here."""
    from _cells import tiny_cell
    from harness import drivers
    cell = tiny_cell(name)
    d = drivers.DRIVERS[cell.kind](cell, 3_300_000_071, card)
    d.setup()
    with drivers.window_range(True) as prof:
        measured = d.window(1.0)
    w = trace.read(prof, measured["steps"], cell)
    layers = LAYERS[cell.kind]
    seq = [n[len(marks.PREFIX):] for n, _, _ in sorted(w.kernels, key=lambda k: k[1])
           if marks.PREFIX in n]
    # the pairs in order: layer i's begin, its end, then layer i + 1's
    want = [f"{layer}_{edge}" for layer in layers for edge in ("begin", "end")]
    whole = len(seq) // len(want)
    assert seq == (want * (whole + 1))[:len(seq)], seq
    held = (sum("corr_fwd_kernel" in n for n, _, _ in w.kernels)
            // len(corr.calls(cell.model, cell.traffic)))
    assert 1 < held <= w.steps and held - 1 <= whole <= w.steps, (whole, held, w.steps)
    for layer in layers:
        assert whole <= len(marks.spans(w, layer)) <= w.steps, layer
    assert sum(sum(marks.spans(w, layer)) for layer in layers) < w.window_s
    for m in cell.per_layer:
        if m["name"] in MARK_READERS:
            assert spec.metric_reader(m["name"]).read(w) > 0
