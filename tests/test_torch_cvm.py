"""Port vs JAX: the whole CVM forward (eval mode) on tiny(), tiny with an
orientation prior (bins -1..1), tiny with centre-window matching, and the
port's fused decoder stages (lmu_fused_min_res=32) against the JAX unfused
forward, and tiny on a 160-column ground image (a FoV slice), with JAX
weights carried across by state_dict_from_jax and loaded strictly. Slow
cases run the real VIGOR, KITTI and Oxford geometries at batch 1."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _helpers import assert_ori_close
from _torch_helpers import HEATMAP_ATOL, OUT_TOL, jax_variables
from ccvpe_tpu.core import config as jcfg
from ccvpe_tpu.models.cvm import CVM as JaxCVM
from ccvpe_tpu_torch.core import config as tcfg
from ccvpe_tpu_torch.models.cvm import CVM, build_cvm, check_supported
from ccvpe_tpu_torch.utils.convert import state_dict_from_jax

# name -> (overrides of both configs, overrides of the port's only)
VARIANTS = {
    "tiny": ({}, {}),
    "ori_prior": ({"ori_noise": 90.0}, {}),
    "center_window": ({"center_window": True}, {}),
    "lmu_fused": ({}, {"lmu_fused_min_res": 32}),
    # a FoV-sliced panorama: 160 columns, VIGOR's 640 at FoV 90 (static-224
    # SAME and circular pads at that width), each scale's descriptor shorter
    # than its D and embedded at offset 0
    "fov_width_160": ({"grd_size": (64, 160), "grd_desc_channels": (16, 8, 4, 2, 1, 1)}, {}),
}


def run_both(preset, overrides, batch, seed, port_overrides=None):
    jax_cfg = dataclasses.replace(getattr(jcfg, preset)(), **overrides)
    port_cfg = dataclasses.replace(getattr(tcfg, preset)(), **overrides,
                                   **(port_overrides or {}))
    rng = np.random.default_rng(seed)
    hg, wg = jax_cfg.grd_size
    hs, ws = jax_cfg.sat_size
    grd = rng.normal(size=(batch, hg, wg, 3)).astype(np.float32)
    sat = rng.normal(size=(batch, hs, ws, 3)).astype(np.float32)
    model = JaxCVM(jax_cfg)
    variables = jax_variables(model, grd[:1], sat[:1], False, seed=seed)
    ref = jax.jit(lambda v, g, s: model.apply(v, g, s, False))(variables, grd, sat)
    ref = jax.tree.map(np.asarray, ref)

    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             port_cfg.num_scales)
    port = build_cvm(port_cfg, "cpu", state_dict=sd)
    with torch.inference_mode():
        out = port(torch.from_numpy(grd), torch.from_numpy(sat))
    # the raw ori head output, from an unfused run (a fused final stage
    # never calls the head module)
    unfused = build_cvm(dataclasses.replace(port_cfg, lmu_fused_min_res=0), "cpu",
                        state_dict=sd)
    raw = {}
    unfused.conv1_ori.register_forward_hook(lambda m, i, o: raw.update(ori=o))
    with torch.inference_mode():
        unfused(torch.from_numpy(grd), torch.from_numpy(sat))
    raw_norm = torch.linalg.vector_norm(raw["ori"], dim=1)[..., None].numpy()
    return ref, out, raw_norm


@pytest.fixture(scope="module", params=list(VARIANTS))
def outputs(request):
    overrides, port_overrides = VARIANTS[request.param]
    return run_both("tiny", overrides, batch=2, seed=11, port_overrides=port_overrides)


def test_logits_match_jax(outputs):
    ref, out, _ = outputs
    assert tuple(out.logits.shape) == ref.logits.shape
    np.testing.assert_allclose(out.logits.numpy(), ref.logits, **OUT_TOL)


def test_heatmap_matches_jax(outputs):
    ref, out, _ = outputs
    assert tuple(out.heatmap.shape) == ref.heatmap.shape
    np.testing.assert_allclose(out.heatmap.numpy(), ref.heatmap, atol=HEATMAP_ATOL)


def test_ori_matches_jax(outputs):
    ref, out, raw_norm = outputs
    assert tuple(out.ori.shape) == ref.ori.shape
    assert_ori_close(out.ori.numpy(), ref.ori, raw_norm)


def test_matching_scores_match_jax(outputs):
    ref, out, _ = outputs
    assert len(out.matching_scores) == len(ref.matching_scores) == 6
    for i, (a, b) in enumerate(zip(out.matching_scores, ref.matching_scores)):
        assert tuple(a.shape) == b.shape, i
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"scale {i + 1}", **OUT_TOL)


def test_ori_prior_returns_full_bottleneck_stack():
    cfg = dataclasses.replace(tcfg.tiny(), ori_noise=90.0)
    assert cfg.restricted_bins == (-1, 0, 1)
    model = build_cvm(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    with torch.inference_mode():
        out = model(torch.zeros(1, hg, wg, 3), torch.ones(1, hs, ws, 3))
    ks = [s.shape[-1] for s in out.matching_scores]
    assert ks == [4, 3, 3, 3, 3, 3]


@pytest.mark.parametrize("field", ["spatial_axis", "ori_axis"])
def test_model_axis_options_build_and_run_unsharded(field):
    """ModelConfig's model-axis fields build and, with one process (the
    mesh (1, 1): a model axis of size 1), run the unsharded forward with
    its bits (tests/test_torch_model_axis.py runs them sharded)."""
    cfg = dataclasses.replace(tcfg.tiny(), **{field: "model"})
    check_supported(cfg)
    hg, wg = cfg.grd_size
    hs, ws = cfg.sat_size
    grd, sat = torch.zeros(1, hg, wg, 3), torch.ones(1, hs, ws, 3)
    outs = []
    for c in (cfg, tcfg.tiny()):
        model = build_cvm(c, "cpu", generator=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            outs.append(model(grd, sat))
    assert torch.equal(outs[0].logits, outs[1].logits)
    assert torch.equal(outs[0].ori, outs[1].ori)


def test_bad_corr_impl_raises():
    with pytest.raises(ValueError, match="corr_impl"):
        check_supported(dataclasses.replace(tcfg.tiny(), corr_impl="pallas"))


@pytest.mark.parametrize("field,value", [("deconv_impl", "pallas"), ("remat_policy", "save_all"),
                                         ("compute_dtype", "float16"), ("ori_window", 156),
                                         ("ori_window", 162), ("ori_window", 260),
                                         ("circular_impl", "roll")])
def test_bad_option_values_raise(field, value):
    with pytest.raises(ValueError, match=field):
        check_supported(dataclasses.replace(tcfg.tiny(sat=256), **{field: value}))


def test_phase_space_and_fused_stages_are_exclusive():
    """The JAX package asserts it (models/cvm.py:126-128); the port raises."""
    cfg = dataclasses.replace(tcfg.tiny(), phase_space_min_res=32, lmu_fused_min_res=32)
    with pytest.raises(ValueError, match="phase_space_min_res and lmu_fused_min_res"):
        CVM(cfg)


@pytest.mark.parametrize("over", [dict(compute_dtype="bfloat16", lmu_fused_min_res=256),
                                  dict(circular_impl="edgefix"), dict(phase_space_min_res=256)],
                         ids=["bf16_fused", "edgefix", "phase_space"])
def test_the_rest_of_model_config_is_accepted(over):
    """Every ModelConfig option the JAX package runs on one device builds,
    with the reference's state-dict names."""
    model = CVM(dataclasses.replace(tcfg.vigor(), **over))
    assert set(model.state_dict()) == set(CVM(tcfg.vigor()).state_dict())
    assert model.grd_efficientnet._conv_stem.edgefix == (over.get("circular_impl") == "edgefix")


@pytest.mark.parametrize("policy", ["none", "save_dw"])
def test_bench_configuration_is_accepted(policy):
    """bench.py:64-75's train configuration (vigor() with remat, the conv
    deconv, bf16, the ori window and corr_bf16), remat_decoder on too."""
    cfg = dataclasses.replace(tcfg.vigor(), remat_backbone=True, deconv_impl="conv",
                              compute_dtype="bfloat16", remat_skip_blocks=2,
                              remat_policy=policy, ori_window=160, lmu_fused_min_res=0,
                              corr_bf16=True, remat_decoder=True)
    model = CVM(cfg)
    assert model.grd_efficientnet.remat and model.sat_efficientnet.remat_policy == policy
    assert model.deconv6.impl == "conv" and model.conv1.compute_dtype == torch.bfloat16


def test_state_dict_names_are_the_references():
    names = set(CVM(tcfg.tiny()).state_dict())
    for key in ("grd_efficientnet._blocks.3._depthwise_conv.weight",
                "grd_efficientnet._bn1.running_var",
                "grd_feature_to_descriptor2.2.weight",
                "sat_feature_to_descriptors.1.weight",
                "deconv6.weight", "conv6.0.weight", "deconv1_ori.bias",
                "conv1_ori.2.weight", "conv1.2.bias"):
        assert key in names, key
    assert "conv1.0.bias" in names and "conv2_ori.2.weight" in names


def assert_geometry_matches(preset, seed):
    ref, out, raw_norm = run_both(preset, {}, batch=1, seed=seed)
    errs = {"logits": np.abs(out.logits.numpy() - ref.logits).max(),
            "heatmap": np.abs(out.heatmap.numpy() - ref.heatmap).max(),
            "scores": max(np.abs(a.numpy() - b).max()
                          for a, b in zip(out.matching_scores, ref.matching_scores))}
    print(f"{preset} geometry, port vs JAX max abs:",
          {k: float(f"{v:.3g}") for k, v in errs.items()})
    np.testing.assert_allclose(out.logits.numpy(), ref.logits, **OUT_TOL)
    np.testing.assert_allclose(out.heatmap.numpy(), ref.heatmap, atol=HEATMAP_ATOL)
    assert_ori_close(out.ori.numpy(), ref.ori, raw_norm)
    assert len(out.matching_scores) == len(ref.matching_scores) == 6
    for a, b in zip(out.matching_scores, ref.matching_scores):
        np.testing.assert_allclose(a.numpy(), b, **OUT_TOL)


@pytest.mark.slow
def test_vigor_geometry_matches_jax():
    assert_geometry_matches("vigor", seed=12)


@pytest.mark.slow
def test_kitti_geometry_matches_jax():
    """D = 2048, K = 16, the level-6 shift of 8, a 256 x 1024 ground image
    without circular padding."""
    assert_geometry_matches("kitti", seed=13)


@pytest.mark.slow
def test_oxford_geometry_matches_jax():
    """A 154 x 231 ground image, centre-window matching."""
    assert_geometry_matches("oxford", seed=14)
