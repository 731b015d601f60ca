"""Remat in the port (ModelConfig.remat_backbone, remat_skip_blocks,
remat_policy, remat_decoder) against no remat, with drop-connect on and
the same generator seed, on tiny() on the CPU.

flax's remat is functional; torch.utils.checkpoint reruns the module in the
backward, which would (a) apply BatchNorm's running-stat update a second
time and (b) draw drop-connect uniforms from the generator again, so a new
mask. The port updates the stats in the forward only and draws the
uniforms outside the checkpointed region. So a remat step must equal the
plain one: losses, gradients, BN buffers (num_batches_tracked included) and
the generator's state after the step, to the bit (the CPU recomputes the
same values in the same order)."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import random_init_
from ccvpe_tpu_torch.train import step as tstep

REMATS = {
    "backbone": dict(remat_backbone=True),
    "backbone_skip2": dict(remat_backbone=True, remat_skip_blocks=2),
    "backbone_save_dw": dict(remat_backbone=True, remat_policy="save_dw"),
    "backbone_save_dw_skip2": dict(remat_backbone=True, remat_skip_blocks=2,
                                   remat_policy="save_dw"),
    "decoder": dict(remat_decoder=True),
    "all": dict(remat_backbone=True, remat_skip_blocks=2, remat_policy="save_dw",
                remat_decoder=True),
}


def _batch(cfg, b=2, seed=9):
    rng = np.random.default_rng(seed)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    return tstep.Batch(*map(torch.from_numpy, (
        rng.integers(0, 256, (b, hg, wg, 3), dtype=np.uint8),
        rng.integers(0, 256, (b, hs, ws, 3), dtype=np.uint8),
        rng.uniform(-20, 20, b).astype(np.float32),
        rng.uniform(-20, 20, b).astype(np.float32),
        rng.uniform(0, 360, b).astype(np.float32))))


def one_step(cfg):
    """One train step from weights of torch seed 0, drop-connect from a
    generator of seed 5: metrics, gradients, buffers, the generator state."""
    torch.manual_seed(123)       # the global RNG is not the masks' source
    model = random_init_(tstep.CVM(cfg).to_empty(device="cpu"), torch.Generator().manual_seed(0))
    state = tstep.create_train_state(cfg, tcfg.TrainConfig(), device="cpu",
                                     state_dict=model.state_dict())
    gen = torch.Generator().manual_seed(5)
    state, metrics = tstep.make_train_step(cfg, tcfg.TrainConfig())(state, _batch(cfg), gen)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={n: p.grad for n, p in state.model.named_parameters()},
                buffers=dict(state.model.named_buffers()),
                params=dict(state.model.named_parameters()),
                gen=gen.get_state())


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def plain(request):
    cfg = dataclasses.replace(tcfg.tiny(), compute_dtype=request.param)
    return cfg, one_step(cfg)


@pytest.mark.parametrize("name", list(REMATS))
def test_remat_step_equals_plain_step(plain, name):
    cfg, want = plain
    got = one_step(dataclasses.replace(cfg, **REMATS[name]))
    assert got["metrics"] == want["metrics"]
    assert torch.equal(got["gen"], want["gen"])                 # (b): no extra draws
    for n, b in want["buffers"].items():                         # (a): one update
        assert torch.equal(got["buffers"][n], b), n
    for n, g in want["grads"].items():
        assert torch.equal(got["grads"][n], g), n
    for n, p in want["params"].items():
        assert torch.equal(got["params"][n], p), n


def test_drop_connect_is_on_and_remat_runs(plain):
    """The comparison above means something: drop-connect draws masks in
    the step, the BN stats move, and remat really recomputes in the
    backward: under 'none' the whole block, under 'save_dw' all but the
    depthwise conv, whose output is kept (the checkpoint stops recomputing
    once it has what the backward needs)."""
    cfg, want = plain
    assert want["buffers"]["sat_efficientnet._blocks.5._bn1.num_batches_tracked"] == 1
    assert not torch.equal(want["gen"], torch.Generator().manual_seed(5).get_state())
    for policy, dw_runs in (("none", 2), ("save_dw", 1)):
        calls = []
        cfg_r = dataclasses.replace(cfg, remat_backbone=True, remat_policy=policy)
        model = random_init_(tstep.CVM(cfg_r).to_empty(device="cpu"),
                             torch.Generator().manual_seed(0)).train()
        block = model.grd_efficientnet._blocks[3]
        block._depthwise_conv.register_forward_hook(lambda *a: calls.append("dw"))
        block._bn1.register_forward_hook(lambda *a: calls.append("bn1"))
        out = model(*(tstep.device_normalize(t) for t in _batch(cfg)[:2]),
                    torch.Generator().manual_seed(5))
        assert calls == ["dw", "bn1"]
        (out.logits.sum() + out.ori.sum()).backward()
        assert (calls.count("dw"), calls.count("bn1")) == (dw_runs, 2), policy
