"""JAX CVM variables -> a PyTorch state dict with the reference CCVPE names
(the port's own copy of ccvpe_tpu/utils/torch_convert.py::export_cvm and
flatten, :134-216, 271-280).

The port's modules carry the reference names and layouts, so the result
loads with `CVM.load_state_dict(strict=True)`, and so does a reference .pt.
Inputs are nested mappings of numpy arrays (e.g. `jax.device_get` of the
flax variables); nothing here imports JAX.

Layouts: flax Conv HWIO -> OIHW (transpose 3, 2, 0, 1); depthwise
(k,k,1,C) -> (C,1,k,k); Dense (in,out) -> (out,in); deconv (2,2,in,out)
-> (in,out,2,2); BatchNorm scale/bias + batch_stats mean/var ->
weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Flat = Dict[Tuple[str, ...], Any]


def flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Flat:
    """Flatten a nested mapping to {path tuple: leaf}."""
    out: Flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _deconv(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 0, 1))


def backbone_state_dict(p: Flat, s: Flat, prefix: str = "") -> Dict[str, np.ndarray]:
    """One EfficientNetB0's flat params/batch_stats (paths relative to the
    encoder) -> efficientnet_pytorch names under `prefix`."""
    sd: Dict[str, np.ndarray] = {}

    def bn(path: Tuple[str, ...], name: str):
        sd[f"{prefix}{name}.weight"] = np.asarray(p[path + ("bn", "scale")])
        sd[f"{prefix}{name}.bias"] = np.asarray(p[path + ("bn", "bias")])
        sd[f"{prefix}{name}.running_mean"] = np.asarray(s[path + ("bn", "mean")])
        sd[f"{prefix}{name}.running_var"] = np.asarray(s[path + ("bn", "var")])
        sd[f"{prefix}{name}.num_batches_tracked"] = np.asarray(0)

    sd[f"{prefix}_conv_stem.weight"] = _conv(p[("stem_conv", "kernel")])
    bn(("stem_bn",), "_bn0")
    i = 0
    while (f"block{i}", "depthwise_conv", "kernel") in p:
        blk = (f"block{i}",)
        t = f"_blocks.{i}."
        if blk + ("expand_conv", "kernel") in p:
            sd[f"{prefix}{t}_expand_conv.weight"] = _conv(p[blk + ("expand_conv", "kernel")])
            bn(blk + ("bn0",), t + "_bn0")
        sd[f"{prefix}{t}_depthwise_conv.weight"] = _conv(p[blk + ("depthwise_conv", "kernel")])
        bn(blk + ("bn1",), t + "_bn1")
        for part in ("reduce", "expand"):
            sd[f"{prefix}{t}_se_{part}.weight"] = _conv(p[blk + ("se", part, "kernel")])
            sd[f"{prefix}{t}_se_{part}.bias"] = np.asarray(p[blk + ("se", part, "bias")])
        sd[f"{prefix}{t}_project_conv.weight"] = _conv(p[blk + ("project_conv", "kernel")])
        bn(blk + ("bn2",), t + "_bn2")
        i += 1
    sd[f"{prefix}_conv_head.weight"] = _conv(p[("head_conv", "kernel")])
    bn(("head_bn",), "_bn1")
    return sd


def double_conv_state_dict(p: Flat, prefix: str = "") -> Dict[str, np.ndarray]:
    """flax conv_a / conv_b -> Sequential .0 / .2 under `prefix`."""
    sd = {}
    for src, idx in (("conv_a", 0), ("conv_b", 2)):
        sd[f"{prefix}{idx}.weight"] = _conv(p[(src, "kernel")])
        sd[f"{prefix}{idx}.bias"] = np.asarray(p[(src, "bias")])
    return sd


def deconv_state_dict(p: Flat, prefix: str = "") -> Dict[str, np.ndarray]:
    return {f"{prefix}weight": _deconv(p[("kernel",)]),
            f"{prefix}bias": np.asarray(p[("bias",)])}


def grd_head_state_dict(p: Flat, prefix: str = "") -> Dict[str, np.ndarray]:
    """GroundDescriptorHead: compress -> .0, h_weight [1,H] -> .2 [1,H,1,1]."""
    hw = np.asarray(p[("h_weight",)])
    return {f"{prefix}0.weight": _conv(p[("compress", "kernel")]),
            f"{prefix}0.bias": np.asarray(p[("compress", "bias")]),
            f"{prefix}2.weight": hw.reshape(1, hw.shape[1], 1, 1),
            f"{prefix}2.bias": np.asarray(p[("h_bias",)])}


def sat_head_state_dict(p: Flat, prefix: str = "") -> Dict[str, np.ndarray]:
    return {f"{prefix}1.weight": np.ascontiguousarray(np.asarray(p[("linear", "kernel")]).T),
            f"{prefix}1.bias": np.asarray(p[("linear", "bias")])}


def _sub(flat: Flat, *path: str) -> Flat:
    n = len(path)
    return {k[n:]: v for k, v in flat.items() if k[:n] == path}


def state_dict_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                        num_scales: int = 6) -> Dict[str, torch.Tensor]:
    """JAX CVM variables (numpy leaves) -> reference-named torch state dict."""
    p, s = flatten(params), flatten(batch_stats)
    sd: Dict[str, np.ndarray] = {}
    for enc, torch_enc in (("grd_encoder", "grd_efficientnet"),
                           ("sat_encoder", "sat_efficientnet")):
        sd.update(backbone_state_dict(_sub(p, enc), _sub(s, enc), f"{torch_enc}."))
    for n in range(1, num_scales + 1):
        sd.update(grd_head_state_dict(_sub(p, f"grd_desc{n}"),
                                      f"grd_feature_to_descriptor{n}."))
    sd.update(sat_head_state_dict(_sub(p, "sat_desc"), "sat_feature_to_descriptors."))
    # decoders: stages 1..6 coarse->fine = reference deconv6..deconv1
    for st in range(num_scales):
        ref_n = num_scales - st
        for branch, suffix in (("loc", ""), ("ori", "_ori")):
            stage = f"{branch}_stage{st + 1}"
            sd.update(deconv_state_dict(_sub(p, stage, "deconv"),
                                        f"deconv{ref_n}{suffix}."))
            if ref_n > 1:   # conv6..conv2 are double convs; conv1 is the head
                sd.update(double_conv_state_dict(_sub(p, stage, "conv"),
                                                 f"conv{ref_n}{suffix}."))
    sd.update(double_conv_state_dict(_sub(p, "loc_head"), "conv1."))
    sd.update(double_conv_state_dict(_sub(p, "ori_head"), "conv1_ori."))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pt/.pth state dict, or an .npz archive of the same keys.
    An Orbax run directory needs JAX to read, so it raises: export it first
    with ccvpe_tpu.utils.torch_convert.export_cvm. (The port's own Trainer
    directories are read by train/evaluate.py::load_model.)"""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory without the port's step files (an Orbax "
            "checkpoint?); the port reads reference .pt or .npz state dicts and "
            "its own Trainer's checkpoint directories. Export one from JAX with "
            "ccvpe_tpu.utils.torch_convert.export_cvm")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def init_with_pretrained_backbone(model: torch.nn.Module,
                                  backbone_sd: Mapping[str, Any]) -> torch.nn.Module:
    """Fill BOTH encoders of a CVM, in place, from one ImageNet
    EfficientNet-B0 state dict (the port of
    ccvpe_tpu/utils/torch_convert.py::init_with_pretrained_backbone, :219).

    The reference initializes the ground and aerial encoders from the same
    pretrained weights (models.py:55,99), dropping the classifier
    (efficientnet_pytorch/utils.py:729-758): the `_fc.*` keys are skipped,
    and so are `num_batches_tracked` counters, which the JAX package's BN
    does not keep. Every other key must name a tensor of the encoder, of the
    same shape (KeyError, ValueError otherwise), and every parameter and
    running stat of the encoder must be given (KeyError). Heads and decoders
    keep their weights. `backbone_sd` maps the efficientnet_pytorch names to
    tensors or numpy arrays (e.g. load_state_dict_file of
    efficientnet-b0-355c32eb.pth)."""
    src = {k: torch.as_tensor(np.asarray(v)) for k, v in backbone_sd.items()
           if not k.startswith("_fc.") and not k.endswith("num_batches_tracked")}
    for encoder in (model.grd_efficientnet, model.sat_efficientnet):
        dst = {k: v for k, v in encoder.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        for k, v in src.items():
            if k not in dst:
                raise KeyError(f"unexpected backbone key {k}")
            if tuple(v.shape) != tuple(dst[k].shape):
                raise ValueError(f"{k}: {tuple(v.shape)} != {tuple(dst[k].shape)}")
        missing = sorted(set(dst) - set(src))
        if missing:
            raise KeyError(f"backbone keys missing: {missing[:5]}")
        for k, v in src.items():
            dst[k].copy_(v)
    return model
