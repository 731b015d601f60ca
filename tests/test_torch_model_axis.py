"""The port's model axis against the JAX package: a ('data', 'model') mesh
of gloo ranks (tests/_torch_dist.py), ModelConfig.spatial_axis (the
decoders' rows split over the model ranks, halo exchange for the 3x3
convs), ModelConfig.ori_axis (B1 on each rank's block of the bins) and
rolled_corr_bin_sharded, on tiny() in float32 with weights carried across
by utils/convert.py::state_dict_from_jax.

- The bin-sharded correlation at model sizes 2 and 4, with batch_axis
  'data' and None, against JAX's rolled_corr_bin_sharded on the 8-device
  CPU mesh (tests/conftest.py) and JAX's rolled_corr, atol 2e-5; the
  ori_axis route with odd restricted bins (-1, 0, 1, an empty block at
  model size 4) and all the bins, values and both inputs' gradients
  against the port's one-process ones; 18 bins refused at model size 4.
- The forward at (1, 2) and (2, 2) with spatial_axis, ori_axis and both,
  and ori_axis under the orientation prior, against the JAX package's
  unsharded forward at the JAX sharding tests' tolerances
  (tests/test_spatial_sharding.py: heatmap 1e-5, logits 2e-3, scores
  1e-4, ori through _helpers.assert_ori_close).
- The train step at (1, 2) and (2, 2), global batch 8, both axes,
  ori_window off, as __graft_entry__.py::dryrun_multichip runs it,
  drop-connect off, against the JAX single-process step: losses, BN
  running stats and parameters after Adam at
  tests/test_torch_train_step.py's tolerances, the whole gradient as
  GRAD_JAX_RTOL's note says. At (2, 2) with drop-connect on, both axes,
  and ori_axis with fused stages (tiny(sat=256), the plain versions on
  the CPU), against the same mesh without the axes, which is the data
  axis alone (held to one process and to JAX in
  tests/test_torch_distributed.py): the same losses, the first step's
  whole gradient within GRAD_RTOL, every rank the same bits.
- Model size 1: both axes give the bits of neither, forward and step.
- Refusals: spatial_axis with lmu_fused_min_res, a model size that does
  not divide the processes, an axis name the mesh lacks, the data axis.

The ranks run while this process computes the JAX references."""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ccvpe_tpu.nn.efficientnet as jeff
import ccvpe_tpu_torch.nn.efficientnet as teff
from _helpers import assert_ori_close
from _torch_dist import finish, start
from _torch_helpers import jax_variables, one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.core.mesh import make_mesh as jax_make_mesh
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.ops import corr as jcorr
from ccvpe_tpu.train import step as jstep
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.models.cvm import CVM, build_cvm, random_init_
from ccvpe_tpu_torch.ops.corr import rolled_corr
from ccvpe_tpu_torch.train import step as tstep
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

LR = 1e-4
CORR_ATOL = 2e-5
HEATMAP_ATOL, LOGITS_ATOL, SCORES_ATOL = 1e-5, 2e-3, 1e-4
LOSS_RTOL, GRAD_ATOL = 1e-4, 5e-4
MEAN_ATOL, VAR_RTOL, VAR_ATOL = 1e-5, 2e-4, 1e-5
# the model axis against the same mesh without it: partial sums of the
# decoders' weight gradients and the bins' cotangents in another order
# (1.3e-6 on these inputs)
GRAD_RTOL = 1e-5
# the whole gradient against JAX's on one data process: float32 sums in
# another order (the one-process port is 3.6e-5 from JAX here). Per tensor
# the one-process port at batch 8 reaches 9.4e-4 of a tensor's max abs
# (deconv4_ori.bias), past test_torch_train_step.py's 5e-4 at batch 2, and
# a data axis of 2 x 4 rows moves conv5.0.weight by 0.14 of its max abs (a
# ReLU at 0 flips under BatchNorm's moments in another order, 2.3e-3 of the
# whole gradient), so the gradients are held as a whole
GRAD_JAX_RTOL = 1e-4

# the correlation: test_corr.py's bin-sharded case on a batch of 4
CORR_SHAPE, CORR_SHIFT, CORR_BINS = (4, 8, 8, 1280), 64, 20
CORR_MESHES = ((2, 2), (1, 4))          # (data, model) on 4 ranks
BINS_CASES = ((-1, 0, 1), None)

MESHES = ((1, 2), (2, 2))
MESH_IDS = ["data1_model2", "data2_model2"]
FWD_BATCH = 4
FWD_CASES = {"spatial": {"spatial_axis": "model"}, "ori": {"ori_axis": "model"},
             "both": {"spatial_axis": "model", "ori_axis": "model"},
             "ori_prior": {"ori_axis": "model", "ori_noise": 90.0}}
TRAIN_BATCH = 8
BOTH = {"spatial_axis": "model", "ori_axis": "model"}
FUSED_ORI = {"ori_axis": "model", "lmu_fused_min_res": 256}
# decoder options that meet a row-sharded map: phase-space stages gather
# their input and run whole; remat recomputes stages with their halos
DECODER_OPTIONS = {"phase_space": {"phase_space_min_res": 64},
                   "remat_decoder": {"remat_decoder": True}}


def corr_inputs():
    rng = np.random.default_rng(40)
    sat = rng.normal(size=CORR_SHAPE).astype(np.float32)
    grd = rng.normal(size=(CORR_SHAPE[0], CORR_SHAPE[-1])).astype(np.float32)
    cot = rng.normal(size=(*CORR_SHAPE[:3], CORR_BINS)).astype(np.float32)
    return sat, grd, cot


def images(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, *cfg.grd_size, 3)).astype(np.float32),
            rng.normal(size=(batch, *cfg.sat_size, 3)).astype(np.float32))


def train_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    b = TRAIN_BATCH
    return (rng.integers(0, 256, (b, hg, wg, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, hs, ws, 3), dtype=np.uint8),
            rng.uniform(-20, 20, b).astype(np.float32),
            rng.uniform(-20, 20, b).astype(np.float32),
            rng.uniform(0, 360, b).astype(np.float32))


@functools.cache
def variables():
    cfg = jcfg.tiny()
    return jax_variables(JaxCVM(cfg), np.zeros((1, *cfg.grd_size, 3), np.float32),
                         np.zeros((1, *cfg.sat_size, 3), np.float32), False, seed=21)


def state_dict():
    v = variables()
    return state_dict_from_jax(v["params"], v["batch_stats"], tcfg.tiny().num_scales)


def fused_state_dict():
    cfg = dataclasses.replace(tcfg.tiny(sat=256), lmu_fused_min_res=256)
    return random_init_(CVM(cfg).to_empty(device="cpu"),
                        torch.Generator().manual_seed(5)).state_dict()


def port_cfg(over, sat=128):
    return dataclasses.replace(tcfg.tiny(sat=sat), **over)


def train_runs(shape):
    """(cases, state_dict, batches) for the ranks of `shape`: both axes and
    none with drop-connect off (the JAX comparison); at (2, 2) also both
    axes and none with drop-connect on, unfused and fused."""
    tc = tcfg.TrainConfig(learning_rate=LR)
    data = [train_batch(tcfg.tiny(), 50)]
    no_axes = {"spatial_axis": None, "ori_axis": None}
    runs = [([(port_cfg(BOTH), tc, (0,), False), (port_cfg(no_axes), tc, (0,), False)],
             state_dict(), data)]
    if shape == (1, 2):
        runs[0][0].extend((port_cfg({**over, **axes}), tc, (9,), True)
                          for over in DECODER_OPTIONS.values() for axes in (BOTH, no_axes))
    if shape == (2, 2):
        runs[0][0].extend([(port_cfg(BOTH), tc, (7,), True), (port_cfg(no_axes), tc, (7,), True)])
        runs.append(([(port_cfg(FUSED_ORI, 256), tc, (8,), True),
                      (port_cfg({**FUSED_ORI, **no_axes}, 256), tc, (8,), True)],
                     fused_state_dict(), [train_batch(tcfg.tiny(sat=256), 51)]))
    return runs


@functools.cache
def jax_forward(over):
    """The JAX package's unsharded forward of tiny() with `over` (a tuple of
    (field, value)) on the forward batch, as numpy."""
    cfg = dataclasses.replace(jcfg.tiny(), **dict(over))
    grd, sat = images(cfg, FWD_BATCH, 60)
    model = JaxCVM(cfg)
    out = jax.jit(lambda v, g, s: model.apply(v, g, s, False))(variables(), grd, sat)
    return jax.tree.map(np.asarray, out)


def raw_ori_norm(over):
    """The norm of the port's pre-normalization ori head output, one
    process (assert_ori_close's floor)."""
    cfg = port_cfg(dict(over))
    grd, sat = images(cfg, FWD_BATCH, 60)
    model = build_cvm(cfg, "cpu", state_dict=state_dict())
    raw = {}
    model.conv1_ori.register_forward_hook(lambda m, i, o: raw.update(ori=o))
    with torch.inference_mode():
        model(torch.from_numpy(grd), torch.from_numpy(sat))
    return torch.linalg.vector_norm(raw["ori"], dim=1)[..., None].numpy()


@functools.cache
def jax_step():
    """The JAX single-process step on the global batch of 8, drop-connect
    off: its new state, metrics and the gradients it applied."""
    cfg = jcfg.tiny()
    train_cfg = jcfg.TrainConfig(learning_rate=LR)
    model = JaxCVM(cfg)
    v = variables()
    tx = jstep.make_optimizer(train_cfg)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jax.tree.map(jnp.asarray, v["batch_stats"]), tx.init(params))
    batch = jstep.Batch(*map(jnp.asarray, train_batch(tcfg.tiny(), 50)))
    with mock.patch.object(jeff, "DROP_CONNECT_RATE", 0.0):
        step = jstep.make_train_step(model, tx, cfg, train_cfg, donate=False)
        loss_fn = jstep.make_loss_fn(model, cfg, train_cfg)

        def both(state, batch, rng):
            new_state, metrics = step(state, batch, rng)
            grads, _ = jax.grad(loss_fn, has_aux=True)(state.params, state.batch_stats, batch,
                                                       rng)
            return new_state, metrics, grads

        new_state, metrics, grads = jax.jit(both)(state, batch, jax.random.PRNGKey(0))
    new_state = jax.tree.map(np.asarray, new_state)
    return dict(metrics={k: float(x) for k, x in metrics.items()},
                grads=state_dict_from_jax(jax.tree.map(np.asarray, grads), v["batch_stats"]),
                state=state_dict_from_jax(new_state.params, new_state.batch_stats))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The (2, 2) suite on 4 ranks and the (1, 2) one on 2, started before
    this process computes the JAX references."""
    tmp = tmp_path_factory.mktemp("model_axis")
    sat, grd, cot = corr_inputs()
    cases = {name: port_cfg(over) for name, over in FWD_CASES.items()}
    fwd = (cases, state_dict(), *images(tcfg.tiny(), FWD_BATCH, 60))
    corr = (CORR_MESHES, sat, grd, CORR_SHIFT, CORR_BINS, BINS_CASES, cot)
    started = {shape: start("model_axis_suite", shape[0] * shape[1], tmp, shape,
                            corr if shape == (2, 2) else None, fwd, train_runs(shape))
               for shape in MESHES}
    for over in FWD_CASES.values():
        jax_forward(tuple((k, v) for k, v in over.items() if k == "ori_noise"))
    jax_step()
    return {shape: finish(s) for shape, s in started.items()}


# --- the bin-sharded correlation ---

@functools.cache
def jax_bin_sharded():
    sat, grd, _ = corr_inputs()
    ref = np.asarray(jcorr.rolled_corr(sat, grd, CORR_SHIFT, CORR_BINS))
    out = {}
    for model in (2, 4):
        m = jax_make_mesh(data=8 // model, model=model)
        for batch_axis in ("data", None):
            out[(model, batch_axis)] = np.asarray(jcorr.rolled_corr_bin_sharded(
                sat, grd, CORR_SHIFT, CORR_BINS, m, batch_axis=batch_axis))
    return ref, out


@pytest.mark.parametrize("shape", CORR_MESHES, ids=["data2_model2", "data1_model4"])
@pytest.mark.parametrize("batch_axis", ["data", None], ids=["batch_data", "batch_none"])
def test_bin_sharded_matches_jax(ranks, shape, batch_axis):
    ref, jax_out = jax_bin_sharded()
    data, model = shape
    for r, got in enumerate(ranks[(2, 2)]):
        out = got["corr"][("bin_sharded", shape, batch_axis)]
        b = CORR_SHAPE[0] // data
        rows = slice((r // model) * b, (r // model + 1) * b) if batch_axis else slice(None)
        np.testing.assert_allclose(out, ref[rows], atol=CORR_ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(out, jax_out[(model, batch_axis)][rows], atol=CORR_ATOL,
                                   err_msg=f"rank {r}")


def test_bin_sharded_refuses_indivisible_bins(ranks):
    for got in ranks[(2, 2)]:
        assert "not divisible by mesh axis 'model' of size 4" in got["corr"][("18 bins", (1, 4))]
        assert ("18 bins", (2, 2)) not in got["corr"]      # 18 bins split over 2


@pytest.mark.parametrize("shape", CORR_MESHES, ids=["data2_model2", "data1_model4"])
@pytest.mark.parametrize("bins", BINS_CASES, ids=["restricted", "all"])
def test_ori_axis_corr_and_grads(ranks, shape, bins):
    """The ori_axis route of rolled_corr_dispatch (blocks of ceil(K / M)
    bins: 2 + 1 and 1 + 1 + 1 + 0 for the restricted 3) against the
    one-process plain correlation and JAX's, and both inputs' gradients
    of sum(out * cot) against the one process's."""
    sat, grd, cot = corr_inputs()
    s = torch.from_numpy(sat).requires_grad_()
    g = torch.from_numpy(grd).requires_grad_()
    want = rolled_corr(s, g, CORR_SHIFT, CORR_BINS, bins=bins)
    (want * torch.from_numpy(cot[..., :want.shape[-1]])).sum().backward()
    jax_want = np.asarray(jcorr.rolled_corr(sat, grd, CORR_SHIFT, CORR_BINS, bins=bins))
    for r, got in enumerate(ranks[(2, 2)]):
        out, s_grad, g_grad = got["corr"][("ori_axis", shape, bins)]
        np.testing.assert_allclose(out, want.detach().numpy(), atol=CORR_ATOL)
        np.testing.assert_allclose(out, jax_want, atol=CORR_ATOL)
        np.testing.assert_allclose(s_grad, s.grad.numpy(), atol=CORR_ATOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(g_grad, g.grad.numpy(), atol=CORR_ATOL, err_msg=f"rank {r}")


# --- the forward ---

@pytest.mark.parametrize("case", list(FWD_CASES))
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_forward_matches_jax(ranks, case, shape):
    over = FWD_CASES[case]
    prior = tuple((k, v) for k, v in over.items() if k == "ori_noise")
    ref = jax_forward(prior)
    raw_norm = raw_ori_norm(prior)
    data, model = shape
    b = FWD_BATCH // data
    for r, got in enumerate(ranks[shape]):
        out = got["forwards"][case]
        rows = slice((r // model) * b, (r // model + 1) * b)
        what = f"{case} {shape} rank {r}"
        np.testing.assert_allclose(out["heatmap"], ref.heatmap[rows], atol=HEATMAP_ATOL,
                                   err_msg=what)
        np.testing.assert_allclose(out["logits"], ref.logits[rows], atol=LOGITS_ATOL,
                                   err_msg=what)
        assert len(out["scores"]) == len(ref.matching_scores)
        for i, (a, w) in enumerate(zip(out["scores"], ref.matching_scores)):
            assert a.shape == w[rows].shape, f"{what} scale {i + 1}"
            np.testing.assert_allclose(a, w[rows], atol=SCORES_ATOL,
                                       err_msg=f"{what} scale {i + 1}")
        assert_ori_close(out["ori"], ref.ori[rows], raw_norm[rows])


# --- the train step ---

def grads_rel(got, want) -> float:
    """||got - want|| / ||want|| over every gradient tensor, in float64."""
    num = sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (num / den) ** 0.5


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_train_step_matches_jax(ranks, shape):
    """Both axes, drop-connect off, one step on the global batch of 8
    against the JAX single-process step: losses, BN running stats and the
    parameters after Adam (test_torch_train_step.py's tolerances), every
    rank the same bits; the whole gradient within GRAD_JAX_RTOL of JAX's
    where the data axis has one process, and at (2, 2) no farther from
    JAX's than the data axis alone puts it (the same mesh without the
    axes) plus GRAD_RTOL."""
    ref = jax_step()
    runs = [r["train"][0][0] for r in ranks[shape]]
    for r, got in enumerate(runs):
        (m,) = got["metrics"]
        assert set(m) == set(ref["metrics"])
        for k, want in ref["metrics"].items():
            np.testing.assert_allclose(m[k], want, rtol=LOSS_RTOL, err_msg=f"rank {r} {k}")
    assert all(got["digest"] == runs[0]["digest"] for got in runs)
    grads, state = runs[0]["grads"], runs[0]["state"]
    want = {k: ref["grads"][k] for k in grads}
    if shape[0] == 1:
        assert grads_rel(grads, want) < GRAD_JAX_RTOL
    else:
        data_axis = ranks[shape][0]["train"][0][1]["grads"]
        assert grads_rel(grads, data_axis) < GRAD_RTOL
        assert grads_rel(grads, want) < grads_rel(data_axis, want) + GRAD_RTOL
    for k, w in ref["state"].items():
        g, w = state[k].numpy(), w.numpy()
        if k.endswith("running_mean"):
            np.testing.assert_allclose(g, w, atol=MEAN_ATOL, err_msg=k)
        elif k.endswith("running_var"):
            np.testing.assert_allclose(g, w, rtol=VAR_RTOL, atol=VAR_ATOL, err_msg=k)
        elif k in grads:
            np.testing.assert_allclose(g, w, atol=2.5 * LR, err_msg=k)


@pytest.mark.parametrize("run", [0, 1], ids=["both_axes", "ori_axis_fused"])
def test_train_step_matches_the_data_axis(ranks, run):
    """(2, 2), drop-connect on: the model axis against the same mesh
    without the axes, whose model ranks each run the data axis's step
    (the model ranks of one data index draw the same masks)."""
    first = 2 if run == 0 else 0
    four = ranks[(2, 2)]
    axes = [r["train"][run][first] for r in four]
    plain = [r["train"][run][first + 1] for r in four]
    for got, want in zip(axes, plain):
        for k, w in want["metrics"][0].items():
            np.testing.assert_allclose(got["metrics"][0][k], w, rtol=GRAD_RTOL, err_msg=k)
    assert all(got["digest"] == axes[0]["digest"] for got in axes)
    assert grads_rel(axes[0]["grads"], plain[0]["grads"]) < GRAD_RTOL
    for k, w in plain[0]["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(axes[0]["state"][k], w, rtol=GRAD_RTOL, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("option", list(DECODER_OPTIONS))
def test_model_axis_composes_with_decoder_options(ranks, option):
    """(1, 2), drop-connect on: both axes with phase-space stages or
    remat_decoder against the same options without the axes."""
    i = 2 + 2 * list(DECODER_OPTIONS).index(option)
    two = ranks[(1, 2)]
    axes, plain = two[0]["train"][0][i], two[0]["train"][0][i + 1]
    for k, w in plain["metrics"][0].items():
        np.testing.assert_allclose(axes["metrics"][0][k], w, rtol=GRAD_RTOL, err_msg=k)
    assert grads_rel(axes["grads"], plain["grads"]) < GRAD_RTOL
    assert two[1]["train"][0][i]["digest"] == axes["digest"]


# --- model size 1, refusals ---

def test_model_size_1_gives_the_same_bits():
    """Both axes on a model axis of size 1 (one process, set_mesh((1, 1))):
    the forward's outputs, one train step's losses, gradients and state
    the same bits as neither."""
    grd, sat = images(tcfg.tiny(), 2, 61)
    batch = train_batch(tcfg.tiny(), 52)
    tc = tcfg.TrainConfig(learning_rate=LR)
    outs, steps = [], []
    for over in ({}, BOTH):
        cfg = port_cfg(over)
        with mesh.set_mesh(mesh.make_mesh(1, 1)):
            model = build_cvm(cfg, "cpu", state_dict=state_dict())
            with torch.inference_mode():
                outs.append(model(torch.from_numpy(grd), torch.from_numpy(sat)))
            state = tstep.create_train_state(cfg, tc, device="cpu", state_dict=state_dict())
            _, m = tstep.make_train_step(cfg, tc)(state, batch,
                                                  torch.Generator().manual_seed(3))
            assert state.model.row_block_params() == []
            steps.append((m, {n: p.grad for n, p in state.model.named_parameters()},
                          state.model.state_dict()))
    a, b = outs
    for x, y in zip((a.logits, a.heatmap, a.ori, *a.matching_scores),
                    (b.logits, b.heatmap, b.ori, *b.matching_scores)):
        assert torch.equal(x, y)
    (ma, ga, sa), (mb, gb, sb) = steps
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_spatial_axis_with_fused_stages_raises():
    with pytest.raises(ValueError, match="cannot combine with spatial_axis"):
        CVM(port_cfg({"spatial_axis": "model", "lmu_fused_min_res": 64}))


def test_model_size_must_divide_the_processes():
    with pytest.raises(ValueError, match="does not divide the 1 processes"):
        mesh.make_mesh(model=2)
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh.make_mesh(data=1, model=2)


@pytest.mark.parametrize("field", ["spatial_axis", "ori_axis"])
@pytest.mark.parametrize("axis,message", [("rows", "no axis 'rows'"),
                                          ("data", "the mesh's data axis")],
                         ids=["unknown", "data"])
def test_axis_the_mesh_cannot_shard_raises(field, axis, message):
    grd, sat = images(tcfg.tiny(), 1, 62)
    model = build_cvm(port_cfg({field: axis}), "cpu", state_dict=state_dict())
    with pytest.raises(ValueError, match=message), torch.inference_mode():
        model(torch.from_numpy(grd), torch.from_numpy(sat))
