"""The port's data axis against the JAX package (ROADMAP A6): the JAX
single-process train step on a global batch of 4 against the port at 2
ranks x 2 rows under gloo (tests/_torch_dist.py), 3 steps from the same
weights (utils/convert.py::state_dict_from_jax), drop-connect off in both
(the RNG streams cannot be aligned). Cases: plain,
infonce_global_negatives, grad_accum_steps=2 (global microbatches of 2
rows, one a rank) and remat. Each JAX case compiles its own step (tens of
seconds alone, minutes beside the suite's other workers), so the fast
lane holds the plain one and the other three are `slow`, as in
test_torch_train_step.py. Every case also runs port against port in the
fast lane, drop-connect on: 2 ranks against one process on the same
global batches, whose drop-connect masks the ranks draw as one process
draws them (the one-process port is held to JAX in
test_torch_train_step.py and test_torch_remat.py).

Tolerances (ROADMAP "Parity"): every loss of every step rtol 1e-4
(float32 sums in another order, over two processes); BN running var rtol
2e-4 / atol 1e-5; the running mean atol 1e-4: the parameters driven by
noise (below) shift the next blocks' batch means, and after 3 steps one
process of the port reads up to 7.6e-5 against JAX on these inputs
(plain 4.9e-5, accum2 7.6e-5), where one step holds 1e-5
(test_torch_train_step.py); parameters after 3 Adam steps
atol 5e-4, but those whose gradient is roundoff of an exact 0 (under 1e-6
of the model's largest, as test_torch_train_step.py::test_grads_match_jax
has it: a block's _bn2.bias, the logits' bias): Adam moves them about
+-lr a step on the sign of noise, so they are held to 2.5 * lr a step
(test_torch_train_step.py's one-step rule). Both ranks end with the same
bits: parameters, BN buffers, gradients and Adam state."""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ccvpe_tpu.nn.efficientnet as jeff
from _torch_dist import finish, start, train_steps
from _torch_helpers import jax_variables, one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu.train import step as jstep
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

LR = 1e-4
STEPS, GLOBAL_BATCH, RANKS = 3, 4, 2
LOSS_RTOL, PARAM_ATOL, NOISE_ATOL_A_STEP = 1e-4, 5e-4, 2.5 * LR
MEAN_ATOL, STAT_RTOL, STAT_ATOL = 1e-4, 2e-4, 1e-5
NOISE_FLOOR = 1e-6

# case -> (ModelConfig overrides, TrainConfig overrides), both packages
CASES = {
    "plain": ({}, {}),
    "global_negatives": ({}, {"infonce_global_negatives": True}),
    "accum2": ({}, {"grad_accum_steps": 2}),
    "remat": ({"remat_backbone": True}, {}),
}


def batches(cfg):
    """STEPS global batches of GLOBAL_BATCH rows, uint8 images, from numpy."""
    out = []
    for seed in range(STEPS):
        rng = np.random.default_rng(30 + seed)
        hg, wg = cfg.grd_size
        hs, ws = cfg.sat_size
        out.append((rng.integers(0, 256, (GLOBAL_BATCH, hg, wg, 3), dtype=np.uint8),
                    rng.integers(0, 256, (GLOBAL_BATCH, hs, ws, 3), dtype=np.uint8),
                    rng.uniform(-20, 20, GLOBAL_BATCH).astype(np.float32),
                    rng.uniform(-20, 20, GLOBAL_BATCH).astype(np.float32),
                    rng.uniform(0, 360, GLOBAL_BATCH).astype(np.float32)))
    return out


@functools.cache
def variables():
    cfg = jcfg.tiny()
    return jax_variables(JaxCVM(cfg), np.zeros((1, *cfg.grd_size, 3), np.float32),
                         np.zeros((1, *cfg.sat_size, 3), np.float32), False, seed=21)


@functools.cache
def jax_run(case):
    """The JAX step, jitted once, STEPS times on the global batches: the
    metrics of each step and the final state as numpy."""
    model_over, train_over = CASES[case]
    cfg = dataclasses.replace(jcfg.tiny(), **model_over)
    train_cfg = jcfg.TrainConfig(learning_rate=LR, **train_over)
    v = variables()
    model = JaxCVM(cfg)
    tx = jstep.make_optimizer(train_cfg)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = jstep.TrainState(jnp.zeros((), jnp.int32), params,
                             jax.tree.map(jnp.asarray, v["batch_stats"]), tx.init(params))
    metrics = []
    with mock.patch.object(jeff, "DROP_CONNECT_RATE", 0.0):
        step = jstep.make_train_step(model, tx, cfg, train_cfg, donate=False)
        for b in batches(cfg):
            state, m = step(state, jstep.Batch(*map(jnp.asarray, b)), jax.random.PRNGKey(0))
            metrics.append({k: float(x) for k, x in m.items()})
    state = jax.tree.map(np.asarray, state)
    return dict(metrics=metrics, state=state_dict_from_jax(state.params, state.batch_stats))


# the JAX comparison's cases in the fast lane; the others are slow
JAX_CASES = [pytest.param(case, marks=() if case == "plain" else pytest.mark.slow)
             for case in CASES]
DROP_SEEDS = (5, 6, 7)


def configs():
    return {case: (dataclasses.replace(tcfg.tiny(), **mo),
                   tcfg.TrainConfig(learning_rate=LR, **to))
            for case, (mo, to) in CASES.items()}


def state_dict():
    v = variables()
    return state_dict_from_jax(v["params"], v["batch_stats"], tcfg.tiny().num_scales)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """At RANKS ranks, in one process group that runs while this process
    computes the fast lane's references (the plain JAX run, the
    one-process port runs): the plain case with drop-connect off, against
    JAX, and every case with drop-connect on, against one process.
    {"jax": {"plain": ranks}, "drop": {case: (one process, ranks)}}; the
    slow cases' JAX runs go to jax_ranks."""
    sd, cfgs, data = state_dict(), configs(), batches(tcfg.tiny())
    cases = ([(*cfgs["plain"], tuple(range(STEPS)), False)]
             + [(c, tc, DROP_SEEDS, True) for c, tc in cfgs.values()])
    started = start("train_cases", RANKS, tmp_path_factory.mktemp("dist"), cases, sd, data)
    jax_run("plain")
    one = {case: train_steps(c, tc, sd, data, DROP_SEEDS) for case, (c, tc) in cfgs.items()}
    ranks = finish(started)
    return {"jax": {"plain": [r[0] for r in ranks]},
            "drop": {case: (one[case], [r[1 + i] for r in ranks])
                     for i, case in enumerate(CASES)}}


def jax_ranks(runs, case, tmp_path):
    """The ranks' run of `case` with drop-connect off (the JAX comparison),
    from `runs` or a process group of its own."""
    if case not in runs["jax"]:
        c, tc = configs()[case]
        started = start("train_cases", RANKS, tmp_path, [(c, tc, tuple(range(STEPS)), False)],
                        state_dict(), batches(tcfg.tiny()))
        jax_run(case)
        runs["jax"][case] = [r[0] for r in finish(started)]
    return runs["jax"][case]


def noise_params(grads):
    """The parameters whose gradient is roundoff of an exact 0."""
    floor = NOISE_FLOOR * max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if float(g.abs().max()) < floor}


def assert_states_close(got, want, grads, what):
    noise = noise_params(grads)
    assert len(noise) < len(grads) // 10, what
    for k, w in want.items():
        g = got[k].numpy()
        w = w.numpy()
        if k.endswith("running_mean"):
            np.testing.assert_allclose(g, w, atol=MEAN_ATOL, err_msg=f"{what} {k}")
        elif k.endswith("running_var"):
            np.testing.assert_allclose(g, w, rtol=STAT_RTOL, atol=STAT_ATOL,
                                       err_msg=f"{what} {k}")
        elif k in grads:
            atol = STEPS * NOISE_ATOL_A_STEP if k in noise else PARAM_ATOL
            np.testing.assert_allclose(g, w, atol=atol, err_msg=f"{what} {k}")


def assert_losses_close(got, want, what):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"{what} step {i} {k}")


@pytest.mark.parametrize("case", JAX_CASES)
def test_losses_match_jax(runs, case, tmp_path):
    ranks, ref = jax_ranks(runs, case, tmp_path), jax_run(case)
    for r, got in enumerate(ranks):
        assert_losses_close(got["metrics"], ref["metrics"], f"{case} rank {r}")


@pytest.mark.parametrize("case", JAX_CASES)
def test_params_and_bn_stats_match_jax(runs, case, tmp_path):
    ranks, ref = jax_ranks(runs, case, tmp_path), jax_run(case)
    got = ranks[0]
    assert set(ref["state"]) == set(got["state"])
    assert_states_close(got["state"], ref["state"], got["grads"], case)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_the_same_bits(runs, case):
    """Parameters, BN buffers, gradients and Adam state, rank 1 against
    rank 0, drop-connect on: every rank applies the same update."""
    _, ranks = runs["drop"][case]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process_with_drop_connect(runs, case):
    """Drop-connect on: each rank draws the masks of the whole batch from
    the one generator and keeps its rows, so 2 ranks train as one process
    on the global batch."""
    one, ranks = runs["drop"][case]
    for r, got in enumerate(ranks):
        assert_losses_close(got["metrics"], one["metrics"], f"{case} rank {r}")
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert_states_close(ranks[0]["state"], one["state"], one["grads"], case)
