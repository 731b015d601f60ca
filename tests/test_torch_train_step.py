"""Port vs JAX: the optimizer and the train step.

make_optimizer is held against optax on identical gradients fed from
numpy (Adam, AdamW, warmup-cosine, clipping by global norm). One train
step on tiny() from the same weights and batch is held against the JAX
package's make_train_step: loss and its parts, every gradient (carried
across by state_dict_from_jax), the BN running stats and the parameters
after Adam. Drop-connect is off in both packages, as in
tests/test_train_parity.py:55 (the RNG streams cannot be aligned).

Tolerances: losses rtol 1e-4 (float32 reductions in another order);
gradients scaled by the reference tensor's max abs, atol 5e-4, as
tests/test_lmu_fused_model.py:137-139; BN mean atol 1e-5 and var rtol
2e-4 / atol 1e-5, as tests/test_train_parity.py:82-85; parameters after
one Adam step atol 2.5 * lr, because Adam's first update is about +-lr
per element and flips sign where a gradient sits near 0.

The JAX step compiles in tens of seconds on the CPU, so the fast lane
holds one JAX unfused step (against the port unfused and fused); the
JAX-fused (interpret mode) and grad-accumulation cases are slow."""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ccvpe_tpu.nn.efficientnet as jeff
import ccvpe_tpu_torch.nn.efficientnet as teff
from _torch_helpers import jax_variables
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.train import step as jstep
from ccvpe_tpu.utils.torch_convert import flatten
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.train import step as tstep
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

LR = 1e-4
LOSS_RTOL = 1e-4
GRAD_ATOL = 5e-4
MEAN_ATOL, VAR_RTOL, VAR_ATOL = 1e-5, 2e-4, 1e-5


# --- the optimizer on identical gradients ---

OPTIMIZERS = {
    "adam": {},
    "adamw": {"optimizer": "adamw", "weight_decay": 0.1},
    "warmup_cosine": {"schedule": "warmup_cosine", "warmup_steps": 2, "total_steps": 4},
    "clip": {"grad_clip_norm": 0.5},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    over = dict(learning_rate=1e-2, **OPTIMIZERS[name])
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    # the first step's global norm (~0.2) is under the clip, the others over
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.05, 1.0, 2.0, 3.0, 0.5)]

    tx = jstep.make_optimizer(jcfg.TrainConfig(**over))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = tstep.make_optimizer(tp.values(), tcfg.TrainConfig(**over))
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{name} {k}")


def test_warmup_cosine_needs_total_steps():
    with pytest.raises(ValueError, match="total_steps"):
        tstep.make_optimizer([torch.zeros(1, requires_grad=True)],
                             tcfg.TrainConfig(schedule="warmup_cosine"))


def test_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.create_train_state(tcfg.tiny(), tcfg.TrainConfig(),
                                 torch.Generator().manual_seed(0))


def test_train_config_keeps_every_jax_field():
    jf = [f.name for f in dataclasses.fields(jcfg.TrainConfig)]
    tf = [f.name for f in dataclasses.fields(tcfg.TrainConfig)]
    assert tf == jf
    assert tcfg.TrainConfig() == tcfg.TrainConfig(**{
        k: getattr(jcfg.TrainConfig(), k) for k in jf})


# --- one train step against the JAX package's ---

def _batch(cfg, b, seed=13):
    rng = np.random.default_rng(seed)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    return jstep.Batch(
        grd=rng.integers(0, 256, (b, hg, wg, 3), dtype=np.uint8),
        sat=rng.integers(0, 256, (b, hs, ws, 3), dtype=np.uint8),
        row_offset=rng.uniform(-20, 20, b).astype(np.float32),
        col_offset=rng.uniform(-20, 20, b).astype(np.float32),
        angle_deg=rng.uniform(0, 360, b).astype(np.float32))


@functools.cache
def jax_step(jax_over, accum):
    """The JAX step's new state and metrics, and the gradients it applied
    (the mean over microbatches, BN stats threaded), from numpy-seeded
    variables; jax_over is a tuple of (field, value) ModelConfig overrides.
    Cached, so one compile serves every case that shares it."""
    cfg = dataclasses.replace(jcfg.tiny(), **dict(jax_over))
    train_cfg = jcfg.TrainConfig(learning_rate=LR, grad_accum_steps=accum)
    batch = _batch(cfg, 2 * accum)
    model = JaxCVM(cfg)
    variables = jax_variables(model, np.zeros((1, *cfg.grd_size, 3), np.float32),
                              np.zeros((1, *cfg.sat_size, 3), np.float32), False, seed=21)
    tx = jstep.make_optimizer(train_cfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params, stats, tx.init(params))
    with mock.patch.object(jeff, "DROP_CONNECT_RATE", 0.0):
        step = jstep.make_train_step(model, tx, cfg, train_cfg, donate=False)
        loss_fn = jstep.make_loss_fn(model, cfg, train_cfg)

        def both(state, batch, rng):
            new_state, metrics = step(state, batch, rng)
            m = batch.grd.shape[0] // accum
            st, gsum = state.batch_stats, None
            for i in range(accum):
                mb = jstep.Batch(*(x[i * m:(i + 1) * m] for x in batch))
                g, (st, _) = jax.grad(loss_fn, has_aux=True)(state.params, st, mb, rng)
                gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
            return new_state, metrics, jax.tree.map(lambda g: g / accum, gsum)

        new_state, metrics, grads = jax.jit(both)(
            state, jstep.Batch(*map(jnp.asarray, batch)), jax.random.PRNGKey(0))
    return dict(variables=variables, batch=batch, new_state=jax.tree.map(np.asarray, new_state),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, grads))


# name -> (JAX overrides, the port's overrides, microbatches per step)
STEPS = [
    pytest.param(((), {}, 1), id="unfused"),
    pytest.param(((), {"lmu_fused_min_res": 32}, 1), id="port_fused"),
    pytest.param(((("lmu_fused_min_res", 32),), {"lmu_fused_min_res": 32}, 1),
                 id="both_fused", marks=pytest.mark.slow),
    pytest.param(((), {}, 2), id="accum2", marks=pytest.mark.slow),
]


@pytest.fixture(scope="module", params=STEPS)
def steps(request):
    jax_over, port_over, accum = request.param
    ref = jax_step(jax_over, accum)
    cfg = dataclasses.replace(tcfg.tiny(), **port_over)
    train_cfg = tcfg.TrainConfig(learning_rate=LR, grad_accum_steps=accum)
    v = ref["variables"]
    sd = state_dict_from_jax(v["params"], v["batch_stats"], cfg.num_scales)
    with mock.patch.object(teff, "DROP_CONNECT_RATE", 0.0):
        state = tstep.create_train_state(cfg, train_cfg, device="cpu", state_dict=sd)
    state, metrics = tstep.make_train_step(cfg, train_cfg)(state, ref["batch"])
    assert state.step == 1
    port = dict(metrics={k: float(x) for k, x in metrics.items()},
                grads={n: p.grad.numpy() for n, p in state.model.named_parameters()},
                state=state.model.state_dict())
    return ref, port


def test_losses_match_jax(steps):
    ref, port = steps
    assert set(port["metrics"]) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(port["metrics"][k], want, rtol=LOSS_RTOL, err_msg=k)


def test_grads_match_jax(steps):
    """Every gradient, scaled by the reference tensor's max abs. Below a
    floor of 1e-6 of the model's largest gradient (float32 keeps about
    seven digits of a loss of ~1e5) a gradient is roundoff of an exact 0:
    e.g. a block's _bn2.bias that reaches the loss only through a 1x1 conv
    into a train-mode BN, which removes any per-channel constant, or the
    logits' bias under the softmax. There both sides must stay under it."""
    ref, port = steps
    want = state_dict_from_jax(ref["grads"], ref["variables"]["batch_stats"])
    assert set(port["grads"]) <= set(want)
    floor = 1e-6 * max(float(np.abs(want[n].numpy()).max()) for n in port["grads"])
    n_noise = 0
    for name, got in port["grads"].items():
        w = want[name].numpy()
        scale = np.abs(w).max()
        if scale < floor:
            n_noise += 1
            assert np.abs(got).max() < floor, name
            continue
        np.testing.assert_allclose(got / scale, w / scale, atol=GRAD_ATOL, err_msg=name)
    assert n_noise < len(port["grads"]) // 10


def test_bn_running_stats_match_jax(steps):
    ref, port = steps
    new = ref["new_state"]
    want = state_dict_from_jax(new.params, new.batch_stats)
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        got = port["state"][k].numpy()
        if k.endswith("running_mean"):
            np.testing.assert_allclose(got, want[k].numpy(), atol=MEAN_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(got, want[k].numpy(), rtol=VAR_RTOL, atol=VAR_ATOL,
                                       err_msg=k)


def test_params_after_adam_match_jax(steps):
    ref, port = steps
    new = ref["new_state"]
    want = state_dict_from_jax(new.params, new.batch_stats)
    old = state_dict_from_jax(ref["variables"]["params"], ref["variables"]["batch_stats"])
    for name in port["grads"]:
        got = port["state"][name].numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=2.5 * LR, err_msg=name)
    moved = max(float(np.abs(port["state"][n].numpy() - old[n].numpy()).max())
                for n in port["grads"])
    assert 0.5 * LR < moved < 1.5 * LR     # Adam's first step is about lr


def test_jax_flatten_keys_match_port_parameters():
    """Every JAX parameter maps to exactly one port parameter (so no
    gradient is silently left out of the comparison above)."""
    ref = jax_step((), 1)
    n_jax = len(flatten(ref["variables"]["params"]))
    n_port = sum(1 for _ in tstep.create_train_state(
        tcfg.tiny(), tcfg.TrainConfig(), torch.Generator().manual_seed(0),
        device="cpu").model.parameters())
    assert n_jax == n_port
