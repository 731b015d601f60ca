"""The plain reference against ccvpe_tpu_torch at tiny widths on the CPU:
the eval forward, and three train steps. (The test imports both; the
reference itself imports nothing of the program.)"""

import pytest
import torch

from _cells import tiny_cell
from harness import check, drivers, traffic
from reference import cvm, train as rtrain


@pytest.mark.parametrize("circular", [True, False])
def test_forward_matches_the_port(circular):
    from ccvpe_tpu_torch.models.cvm import build_cvm
    from ccvpe_tpu_torch.train.step import device_normalize
    model = dict(spec_model(), circular=circular)
    params = rtrain.make_params(model, 11, "cpu")
    port = build_cvm(drivers.model_config(model), "cpu", state_dict=params)
    b = traffic.pool({"pool": 1, "batch": 2, "row_offset": 0.25, "col_offset": 0.25,
                      "angle_deg": [0, 360]}, model, 11, "cpu")[0]
    with torch.no_grad():
        got = port(device_normalize(b.grd), device_normalize(b.sat))
        want = cvm.forward(params, model, b.grd, b.sat)
    torch.testing.assert_close(got.logits, want.logits, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(got.heatmap[..., 0], want.heatmap, atol=1e-7, rtol=1e-4)
    torch.testing.assert_close(got.ori, want.ori, atol=5e-4, rtol=1e-3)
    for s, r in zip(got.matching_scores, want.scores):
        torch.testing.assert_close(s, r, atol=2e-5, rtol=1e-4)
    rows, cols, _ = cvm.decode(want.heatmap, want.ori)
    assert torch.equal(rows, got.heatmap[..., 0].flatten(1).argmax(1) // want.heatmap.shape[2])


def spec_model():
    return tiny_cell("vigor-serve-b8").model


@pytest.mark.parametrize("name", ["vigor-train-b8", "kitti-train-b8"])
def test_three_train_steps_match_the_port(name):
    cell = tiny_cell(name)
    d = drivers.Train(cell, 2 ** 31 + 9, "cpu")
    d.setup()
    d.free()
    numbers = d.check()["numbers"]
    assert check.verdict(numbers, cell.limits), numbers


def test_params_follow_the_seed():
    model = spec_model()
    a = rtrain.make_params(model, 5, "cpu")
    b = rtrain.make_params(model, 5, "cpu")
    c = rtrain.make_params(model, 6, "cpu")
    name = "grd_efficientnet._conv_stem.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    assert float(a[name].std()) == pytest.approx(27 ** -0.5, rel=0.2)
    assert torch.equal(a["grd_efficientnet._bn0.running_var"], torch.ones(32))
