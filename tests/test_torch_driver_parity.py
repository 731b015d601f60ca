"""Port vs JAX: the driver layer on tiny() on the CPU.

- utils/convert.py::init_with_pretrained_backbone against
  ccvpe_tpu/utils/torch_convert.py's on the same synthetic ImageNet
  EfficientNet-B0 state dict (FC head included, dropped by both), JAX
  variables from _torch_helpers.jax_variables carried over with
  state_dict_from_jax: the same state dict to the bit, and the same errors
  for an unexpected key and a shape mismatch.
- MetricWriter writes the same CSV and JSONL rows as JAX's, apart from the
  wall-clock `time`.
- slow: the JAX Trainer.fit and the port's, one epoch of 2 steps plus
  validation, drop-connect off in both (the RNG streams cannot be aligned,
  tests/test_train_parity.py:4); the port warm-started from an .npz of the
  JAX Trainer's initial weights written by export_cvm.

Tolerances of the slow case, each that of one update times the number of
updates (two): parameters atol 2.5 * lr an update, the bound of
test_torch_train_step.py's test_params_after_adam_match_jax (Adam moves each
element by about +-lr an update, with the sign flipped where a gradient sits
near 0); BN running mean atol 1e-5, var rtol 2e-4 / atol 1e-5 an update
(test_train_parity.py:82-85), since the second update's batch statistics
come from weights that already differ by up to 2.5 * lr. The two models'
heatmap peaks are nearer than that, so the port's validation summary is
held to the JAX eval loop on the port's own final weights: decoded angles
per sample 1e-2 deg (as test_torch_evaluate.py), the summary at OUT_TOL,
after same_peaks holds every decoded peak to the JAX one, or to a tie of
the JAX heatmap.
"""

import csv
import json
from unittest import mock

import numpy as np
import pytest
import torch

import ccvpe_tpu.nn.efficientnet as jeff
import ccvpe_tpu_torch.nn.efficientnet as teff
from _torch_driver import few_threads, SyntheticDataset, train_loaders, val_loaders
from _torch_helpers import OUT_TOL, jax_variables, same_peaks
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.core.metrics import MetricWriter as JaxMetricWriter
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.utils import torch_convert
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core.metrics import MetricWriter
from ccvpe_tpu_torch.models.cvm import build_cvm
from ccvpe_tpu_torch.utils.convert import init_with_pretrained_backbone, state_dict_from_jax

pytestmark = pytest.mark.usefixtures("few_threads")

LR = 1e-4
MEAN_ATOL, VAR_RTOL, VAR_ATOL = 1e-5, 2e-4, 1e-5
ANGLE_SAMPLE_ATOL = 1e-2


@pytest.fixture(scope="module")
def variables():
    cfg = jcfg.tiny()
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    return jax_variables(JaxCVM(cfg), np.zeros((1, hg, wg, 3), np.float32),
                         np.zeros((1, hs, ws, 3), np.float32), False, seed=41)


def synthetic_backbone(variables, seed=3):
    """ImageNet-style B0 weights: the reference names, random values of the
    right shapes, and the classifier the real file carries."""
    full = state_dict_from_jax(variables["params"], variables["batch_stats"])
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in full.items():
        if k.startswith("grd_efficientnet."):
            name = k[len("grd_efficientnet."):]
            if name.endswith("num_batches_tracked"):
                sd[name] = v.numpy()
            elif name.endswith("running_var"):
                sd[name] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                sd[name] = rng.normal(size=v.shape).astype(np.float32)
    sd["_fc.weight"] = rng.normal(size=(1000, 1280)).astype(np.float32)
    sd["_fc.bias"] = np.zeros(1000, np.float32)
    return sd


def test_pretrained_backbone_matches_jax(variables):
    backbone = synthetic_backbone(variables)
    want = torch_convert.init_with_pretrained_backbone(variables, backbone)
    want_sd = state_dict_from_jax(want["params"], want["batch_stats"])
    model = build_cvm(tcfg.tiny(), "cpu",
                      state_dict=state_dict_from_jax(variables["params"],
                                                     variables["batch_stats"]))
    got = init_with_pretrained_backbone(model, {k: torch.from_numpy(v)
                                                for k, v in backbone.items()})
    assert got is model
    got_sd = model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


@pytest.mark.parametrize("fault", ["unexpected key", "shape mismatch"])
def test_pretrained_backbone_refuses_like_jax(variables, fault):
    backbone = synthetic_backbone(variables)
    if fault == "unexpected key":
        # a 17th block: B0 has 16 (both converters walk the blocks in order)
        last = max(int(k.split(".")[1]) for k in backbone if k.startswith("_blocks."))
        backbone.update({k.replace(f"_blocks.{last}.", f"_blocks.{last + 1}."): v
                         for k, v in list(backbone.items())
                         if k.startswith(f"_blocks.{last}.")})
        error = KeyError
    else:
        backbone["_conv_stem.weight"] = np.zeros((32, 3, 5, 5), np.float32)
        error = ValueError
    with pytest.raises(error):
        torch_convert.init_with_pretrained_backbone(variables, backbone)
    model = build_cvm(tcfg.tiny(), "cpu",
                      state_dict=state_dict_from_jax(variables["params"],
                                                     variables["batch_stats"]))
    with pytest.raises(error):
        init_with_pretrained_backbone(model, backbone)


def test_metric_writer_matches_jax(tmp_path):
    rows = [(1, {"loss": 3.5, "loss_ce": np.float32(1.25)}),
            (2, {"loss": 2.0, "loss_ce": 0.5}),
            (2, {"val/median_distance_m": 4.75, "val/lat_recall@1": 0.5})]
    outputs = {}
    for name, writer_cls in (("jax", JaxMetricWriter), ("port", MetricWriter)):
        writer = writer_cls(str(tmp_path / name), "tiny")
        for step, scalars in rows:
            writer.write(step, scalars)
        writer.flush()
        with open(tmp_path / name / "tiny.csv", newline="") as f:
            table = [{k: v for k, v in r.items() if k != "time"} for r in csv.DictReader(f)]
        with open(tmp_path / name / "tiny.jsonl") as f:
            lines = [{k: v for k, v in json.loads(line).items() if k != "time"}
                     for line in f]
        outputs[name] = (table, lines)
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"][1]) == 3 and outputs["port"][0][0]["loss"] == "3.5"


def _recording(step, store):
    def wrapped(*args):
        out = step(*args)
        store.append(out)
        return out
    return wrapped


@pytest.mark.slow
def test_trainer_fit_matches_jax(tmp_path):
    from ccvpe_tpu.data.loader import ThreadedLoader as JaxLoader
    from ccvpe_tpu.train.evaluate import eval_over_loader as jax_eval_over_loader
    from ccvpe_tpu.train.step import device_normalize as jax_normalize
    from ccvpe_tpu.train.step import make_eval_decode_step as jax_decode_step
    from ccvpe_tpu.train.trainer import Trainer as JaxTrainer
    from ccvpe_tpu_torch.train.trainer import Trainer

    # the JAX Trainer splits each batch over the host's 8 CPU devices
    batch, n_val = 8, 8
    jax_cfg, port_cfg = jcfg.tiny(), tcfg.tiny()
    train_set, val_set = SyntheticDataset(port_cfg, n=2 * batch), SyntheticDataset(
        port_cfg, n=n_val, seed=100)
    mpp = lambda city: 0.1   # noqa: E731
    common = dict(batch_size=batch, epochs=1, log_every=1, learning_rate=LR)

    with mock.patch.object(jeff, "DROP_CONNECT_RATE", 0.0), \
            mock.patch.object(teff, "DROP_CONNECT_RATE", 0.0):
        jt = JaxTrainer(jax_cfg, jcfg.TrainConfig(**common), workdir=str(tmp_path / "jax"))
        init = torch_convert.export_cvm(jt.state.params, jt.state.batch_stats)
        np.savez(tmp_path / "init.npz", **init)
        pt = Trainer(port_cfg, tcfg.TrainConfig(**common, warm_start=str(tmp_path / "init.npz")),
                     workdir=str(tmp_path / "port"), device="cpu")
        port_summary = {}
        validate = pt.validate
        pt.validate = lambda *a, **k: port_summary.update(validate(*a, **k)) or port_summary
        port_out = []
        pt.eval_step = _recording(pt.eval_step, port_out)
        jt.fit(train_loaders(train_set, batch, JaxLoader), val_loaders(val_set, batch, JaxLoader),
               mpp)
        pt.fit(train_loaders(train_set, batch), val_loaders(val_set, batch), mpp)

    assert int(jt.state.step) == pt.state.step == 2
    updates = 2
    want_sd = state_dict_from_jax(jax_tree_numpy(jt.state.params),
                                  jax_tree_numpy(jt.state.batch_stats))
    got_sd = pt.state.model.state_dict()
    params = dict(pt.state.model.named_parameters())
    for k, w in want_sd.items():
        got, w = got_sd[k].numpy(), w.numpy()
        if k in params:
            np.testing.assert_allclose(got, w, rtol=0, atol=updates * 2.5 * LR, err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(got, w, rtol=0, atol=updates * MEAN_ATOL, err_msg=k)
        elif k.endswith("running_var"):
            np.testing.assert_allclose(got, w, rtol=updates * VAR_RTOL,
                                       atol=updates * VAR_ATOL, err_msg=k)

    # The two models lie within a few lr of each other, and the random tiny
    # model's heatmap peaks are nearer than that, so the port's validation
    # is held to JAX's eval loop on the port's own final weights.
    variables = torch_convert.to_variables(
        *torch_convert.convert_cvm({k: v.numpy() for k, v in got_sd.items()}),
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    jax_out = []
    want = jax_eval_over_loader(_recording(jax_decode_step(jt.model, jax_cfg), jax_out),
                                variables["params"], variables["batch_stats"],
                                val_loaders(val_set, batch, JaxLoader)(0), jax_cfg, mpp)
    jax_rows, jax_cols, jax_angle = (np.concatenate([np.asarray(o[i]) for o in jax_out])
                                     for i in range(3))
    port_rows, port_cols, port_angle = (np.concatenate([o[i].numpy() for o in port_out])[:n_val]
                                        for i in range(3))
    grd = np.stack([val_set[i]["grd"] for i in range(n_val)])
    sat = np.stack([val_set[i]["sat"] for i in range(n_val)])

    def jax_heatmap(idx):
        out = jt.model.apply(variables, jax_normalize(grd[idx]), jax_normalize(sat[idx]), False)
        return np.asarray(out.heatmap[..., 0])

    same = same_peaks(port_rows, port_cols, jax_rows, jax_cols, jax_heatmap)
    np.testing.assert_allclose(port_angle[same], jax_angle[same], rtol=0, atol=ANGLE_SAMPLE_ATOL)
    assert port_summary.keys() == want.keys()
    if same.all():
        for k, w in want.items():
            np.testing.assert_allclose(port_summary[k], w, **OUT_TOL, err_msg=k)


def jax_tree_numpy(tree):
    import jax
    return jax.tree.map(np.asarray, tree)
