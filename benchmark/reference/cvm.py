"""The CCVPE cross-view model in plain float32 PyTorch, the benchmark's
yardstick for `correct` (CCVPE, arXiv 2303.05915; the reference
implementation's models.py: CVM_VIGOR at :49, CVM_KITTI at :655).

Written from the published model, not from the code under test: it
imports torch and the standard library only, and takes a configuration as
a plain dict (the `model` group of a file under benchmark/configs/).
Parameters are a flat dict under the reference state-dict names, so the
same weights load into the program by name. No kernel, cache, graph or
fused path: functional conv2d, einsum, softmax.

    params = reference.train.make_params(cfg, seed, device)
    out = forward(params, cfg, grd_u8, sat_u8, train=False)

Departures that are not modelled here raise (centre-window matching, an
orientation prior, mixed precision): the configurations this benchmark
runs use none of them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

# EfficientNet-B0 (Tan and Le 2019): per block (expand ratio, input
# channels, output channels, kernel, stride)
B0 = ((1, 32, 16, 3, 1),
      (6, 16, 24, 3, 2), (6, 24, 24, 3, 1),
      (6, 24, 40, 5, 2), (6, 40, 40, 5, 1),
      (6, 40, 80, 3, 2), (6, 80, 80, 3, 1), (6, 80, 80, 3, 1),
      (6, 80, 112, 5, 1), (6, 112, 112, 5, 1), (6, 112, 112, 5, 1),
      (6, 112, 192, 5, 2), (6, 192, 192, 5, 1), (6, 192, 192, 5, 1), (6, 192, 192, 5, 1),
      (6, 192, 320, 3, 1))
STEM_CHANNELS = 32
BN_EPS = 1e-3
DROP_CONNECT = 0.2
SE_RATIO = 0.25
NOMINAL = 224       # efficientnet_pytorch fixes every SAME pad for a 224 px image
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class Output(NamedTuple):
    logits: torch.Tensor            # [B, H*W]
    heatmap: torch.Tensor           # [B, H, W]
    ori: torch.Tensor               # [B, H, W, 2], unit (cos, sin)
    scores: Tuple[torch.Tensor, ...]  # per scale [B, h, w, K]


def check(cfg: dict) -> None:
    """Raise for an option this reference does not model."""
    if cfg.get("center_window") or cfg.get("ori_noise") is not None:
        raise ValueError("the reference models first-window matching without a prior")
    if cfg.get("compute_dtype", "float32") != "float32" or cfg.get("ori_window", 0):
        raise ValueError("the reference computes the whole model in float32")


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 matrix products and convolutions in full float32 (TF32 off in
    cuBLAS and cuDNN, the default here) or in TF32 (the lower precision a
    control takes); the caller's flags back after the block."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# --- shapes ---

def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def b0_pads() -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """((top, bottom), (left, right)) of the stem and each block's depthwise
    conv, traced from the nominal 224 px."""
    size, pads = NOMINAL, []
    for k, s in [(3, 2)] + [(b[3], b[4]) for b in B0]:
        p = _same(size, k, s)
        pads.append((p, p))
        size = -(-size // s)
    return pads


def b0_sizes(hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Output (H, W) of the stem and of each block for a real input."""
    (h, w), out = hw, []
    for ((pt, pb), (pl, pr)), (k, s) in zip(b0_pads(), [(3, 2)] + [(b[3], b[4]) for b in B0]):
        h, w = (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1
        out.append((h, w))
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """name -> (kind, shape) of every parameter and BN buffer, in the
    reference's state-dict names. kind: 'w' (a conv or linear weight, drawn
    with std 1/sqrt(fan_in), fan_in in `fan_in`), 'b' (a bias), 'bn_w',
    'bn_b', 'bn_mean', 'bn_var', 'bn_n'."""
    check(cfg)
    out: Dict[str, Tuple[str, Tuple[int, ...]]] = {}

    def bn(p, c):
        for part, kind in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out[f"{p}.{part}"] = (kind, (c,))
        out[f"{p}.num_batches_tracked"] = ("bn_n", ())

    feat = cfg["backbone_features"]
    for enc in ("grd_efficientnet", "sat_efficientnet"):
        out[f"{enc}._conv_stem.weight"] = ("w", (STEM_CHANNELS, 3, 3, 3))
        bn(f"{enc}._bn0", STEM_CHANNELS)
        for i, (e, cin, cout, k, _) in enumerate(B0):
            p, mid, red = f"{enc}._blocks.{i}", cin * e, max(1, int(cin * SE_RATIO))
            if e != 1:
                out[f"{p}._expand_conv.weight"] = ("w", (mid, cin, 1, 1))
                bn(f"{p}._bn0", mid)
            out[f"{p}._depthwise_conv.weight"] = ("w", (mid, 1, k, k))
            bn(f"{p}._bn1", mid)
            out[f"{p}._se_reduce.weight"] = ("w", (red, mid, 1, 1))
            out[f"{p}._se_reduce.bias"] = ("b", (red,))
            out[f"{p}._se_expand.weight"] = ("w", (mid, red, 1, 1))
            out[f"{p}._se_expand.bias"] = ("b", (mid,))
            out[f"{p}._project_conv.weight"] = ("w", (cout, mid, 1, 1))
            bn(f"{p}._bn2", cout)
        out[f"{enc}._conv_head.weight"] = ("w", (feat, B0[-1][2], 1, 1))
        bn(f"{enc}._bn1", feat)
    gh = b0_sizes(tuple(cfg["grd_size"]))[-1][0]
    for s, c in enumerate(cfg["grd_desc_channels"]):
        p = f"grd_feature_to_descriptor{s + 1}"
        out[f"{p}.0.weight"] = ("w", (c, feat, 1, 1))
        out[f"{p}.0.bias"] = ("b", (c,))
        out[f"{p}.2.weight"] = ("w", (1, gh, 1, 1))
        out[f"{p}.2.bias"] = ("b", (1,))
    sh, sw = b0_sizes(tuple(cfg["sat_size"]))[-1]
    g, d = cfg["sat_grid"], cfg["sat_desc_dim"]
    out["sat_feature_to_descriptors.1.weight"] = ("w", (d, feat * (sh // g) * (sw // g)))
    out["sat_feature_to_descriptors.1.bias"] = ("b", (d,))
    skips = skip_channels(cfg)
    n = len(cfg["roll_shifts"])
    for branch, suffix, k_in, head in (("loc", "", 1, 1), ("ori", "_ori", cfg["num_bins"], 2)):
        dec, conv = cfg[f"{branch}_deconv_out"], cfg[f"{branch}_conv_out"]
        cin, res = k_in + d, g
        for s in range(n):
            ref = n - s
            out[f"deconv{ref}{suffix}.weight"] = ("w", (cin, dec[s], 2, 2))
            out[f"deconv{ref}{suffix}.bias"] = ("b", (dec[s],))
            res *= 2
            if s < n - 1:
                c = dec[s] + skips.get(res, 0)
                out[f"conv{ref}{suffix}.0.weight"] = ("w", (conv[s], c, 3, 3))
                out[f"conv{ref}{suffix}.0.bias"] = ("b", (conv[s],))
                out[f"conv{ref}{suffix}.2.weight"] = ("w", (conv[s], conv[s], 3, 3))
                out[f"conv{ref}{suffix}.2.bias"] = ("b", (conv[s],))
                cin = conv[s] + (1 if branch == "loc" else 0)
        hid = cfg["head_hidden"]
        out[f"conv1{suffix}.0.weight"] = ("w", (hid, dec[-1], 3, 3))
        out[f"conv1{suffix}.0.bias"] = ("b", (hid,))
        out[f"conv1{suffix}.2.weight"] = ("w", (head, hid, 3, 3))
        out[f"conv1{suffix}.2.bias"] = ("b", (head,))
    return out


def skip_channels(cfg: dict) -> Dict[int, int]:
    """Aerial skip channels by resolution: the last B0 block at each size."""
    return {hw[0]: spec[2] for hw, spec in zip(b0_sizes(tuple(cfg["sat_size"]))[1:], B0)}


def fan_in(name: str, shape: Tuple[int, ...]) -> int:
    if name.startswith("deconv"):
        return shape[0]            # a 2x2 stride-2 transposed conv: one tap a pixel
    return math.prod(shape[1:])


# --- layers ---

def pad_same(x: torch.Tensor, pads, circular: bool) -> torch.Tensor:
    (pt, pb), (pl, pr) = pads
    if circular:
        w = x.shape[-1]
        x = torch.cat([x[..., w - pl:], x, x[..., :pr]], dim=-1) if (pl or pr) else x
        pl = pr = 0
    return F.pad(x, (pl, pr, pt, pb))


def batch_norm(x: torch.Tensor, p: dict, name: str, train: bool) -> torch.Tensor:
    """The batch's statistics (biased variance) in train mode, the running
    ones in eval mode."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS) \
        * w[:, None, None] + b[:, None, None]


def efficientnet(x: torch.Tensor, p: dict, name: str, circular: bool, train: bool,
                 gen: Optional[torch.Generator]):
    """NCHW image -> (features, [16 block outputs])."""
    pads = b0_pads()
    x = F.conv2d(pad_same(x, pads[0], circular), p[f"{name}._conv_stem.weight"], stride=2)
    x = F.silu(batch_norm(x, p, f"{name}._bn0", train))
    blocks = []
    for i, (e, cin, cout, k, s) in enumerate(B0):
        q = f"{name}._blocks.{i}"
        rate = DROP_CONNECT * i / len(B0)
        residual = s == 1 and cin == cout
        u = None
        if train and residual and rate > 0:
            u = torch.rand((x.shape[0], 1, 1, 1), generator=gen, device=x.device)
        h = x
        if e != 1:
            h = F.silu(batch_norm(F.conv2d(h, p[f"{q}._expand_conv.weight"]), p, f"{q}._bn0",
                                  train))
        h = F.conv2d(pad_same(h, pads[i + 1], circular), p[f"{q}._depthwise_conv.weight"],
                     stride=s, groups=h.shape[1])
        h = F.silu(batch_norm(h, p, f"{q}._bn1", train))
        g = h.mean(dim=(2, 3), keepdim=True)
        g = F.conv2d(F.silu(F.conv2d(g, p[f"{q}._se_reduce.weight"], p[f"{q}._se_reduce.bias"])),
                     p[f"{q}._se_expand.weight"], p[f"{q}._se_expand.bias"])
        h = torch.sigmoid(g) * h
        h = batch_norm(F.conv2d(h, p[f"{q}._project_conv.weight"]), p, f"{q}._bn2", train)
        if residual:
            if u is not None:
                keep = 1.0 - rate
                h = h / keep * torch.floor(keep + u)
            h = h + x
        x = h
        blocks.append(x)
    x = F.silu(batch_norm(F.conv2d(x, p[f"{name}._conv_head.weight"]), p, f"{name}._bn1",
                          train))
    return x, blocks


def l2n(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)


def rolled_corr(sat: torch.Tensor, grd: torch.Tensor, shift: int, k: int) -> torch.Tensor:
    """The reference's matching loop: for each orientation bin i, the aerial
    descriptor rolled by -i*shift channels, its first L channels (L the
    ground descriptor's length), and their cosine with the ground
    descriptor. sat [B, h, w, D], grd [B, L] -> [B, h, w, K]."""
    length = grd.shape[-1]
    g_norm = torch.linalg.vector_norm(grd, dim=-1)[:, None, None]
    out = []
    for i in range(k):
        window = torch.roll(sat, -i * shift, dims=-1)[..., :length]
        num = torch.einsum("bhwc,bc->bhw", window, grd)
        out.append(num / (torch.linalg.vector_norm(window, dim=-1) * g_norm))
    return torch.stack(out, dim=-1)


def stage(x: torch.Tensor, p: dict, ref: int, suffix: str,
          skip: Optional[torch.Tensor]) -> torch.Tensor:
    """One upsampling stage: 2x2 stride-2 transposed conv, the aerial skip
    concatenated, conv3x3 -> ReLU -> conv3x3 (stages 2..6; stage 1 is the
    transposed conv alone, the head follows it)."""
    x = F.conv_transpose2d(x, p[f"deconv{ref}{suffix}.weight"], p[f"deconv{ref}{suffix}.bias"],
                           stride=2)
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    if ref > 1:
        x = double_conv(x, p, f"conv{ref}{suffix}")
    return x


def double_conv(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    x = F.relu(F.conv2d(x, p[f"{name}.0.weight"], p[f"{name}.0.bias"], padding=1))
    return F.conv2d(x, p[f"{name}.2.weight"], p[f"{name}.2.bias"], padding=1)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32 NCHW."""
    mean = torch.tensor(MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(STD, dtype=torch.float32, device=img.device)
    return ((img.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


def forward(p: dict, cfg: dict, grd: torch.Tensor, sat: torch.Tensor, train: bool = False,
            gen: Optional[torch.Generator] = None) -> Output:
    """grd [B, Hg, Wg, 3], sat [B, Hs, Ws, 3] uint8. In train mode BN takes
    the batch's statistics and drop-connect
    draws one uniform a sample for each residual block from `gen`, ground
    encoder first, in block order, as efficientnet_pytorch does."""
    check(cfg)
    n, k = len(cfg["roll_shifts"]), cfg["num_bins"]
    grd_feat, _ = efficientnet(normalize(grd), p, "grd_efficientnet", cfg["circular"], train,
                               gen)
    sat_feat, blocks = efficientnet(normalize(sat), p, "sat_efficientnet", False, train, gen)
    skip = {b.shape[2]: b for b in blocks}

    descs = []
    for s in range(n):
        q = f"grd_feature_to_descriptor{s + 1}"
        c = F.conv2d(grd_feat, p[f"{q}.0.weight"], p[f"{q}.0.bias"])     # [B, C, h, w]
        c = F.conv2d(c.permute(0, 2, 3, 1), p[f"{q}.2.weight"], p[f"{q}.2.bias"])
        descs.append(c.flatten(1))                                        # (w, c) order
    b, f, gh, gw = sat_feat.shape
    g = cfg["sat_grid"]
    chunks = sat_feat.reshape(b, f, g, gh // g, g, gw // g).permute(0, 2, 4, 1, 3, 5)
    sat_desc = F.linear(chunks.reshape(b, g, g, -1), p["sat_feature_to_descriptors.1.weight"],
                        p["sat_feature_to_descriptors.1.bias"])          # [B, g, g, D]

    shifts = cfg["roll_shifts"]
    scores = [rolled_corr(sat_desc, descs[0], shifts[0], k)]
    x = sat_desc.permute(0, 3, 1, 2)
    for s in range(n):
        if s > 0:
            scores.append(rolled_corr(x.permute(0, 2, 3, 1), descs[s], shifts[s], k))
        x = torch.cat([scores[s].amax(dim=-1)[:, None], l2n(x, 1)], dim=1)
        x = stage(x, p, n - s, "", skip.get(2 * x.shape[2]) if s < n - 1 else None)
    logits_map = double_conv(x, p, "conv1")
    logits = logits_map.flatten(1)
    heatmap = torch.softmax(logits, dim=-1).reshape(logits_map.shape[0], *logits_map.shape[2:])

    y = torch.cat([scores[0].permute(0, 3, 1, 2), l2n(sat_desc.permute(0, 3, 1, 2), 1)], dim=1)
    for s in range(n):
        y = stage(y, p, n - s, "_ori", skip.get(2 * y.shape[2]) if s < n - 1 else None)
    ori = l2n(double_conv(y, p, "conv1_ori"), 1).permute(0, 2, 3, 1)
    return Output(logits, heatmap, ori, tuple(scores))


def decode(heatmap: torch.Tensor, ori: torch.Tensor):
    """The pose at the heatmap's first maximum: rows, cols [B] and the
    heading in degrees from the (cos, sin) there."""
    b, h, w = heatmap.shape
    idx = heatmap.reshape(b, -1).argmax(dim=-1)
    rows, cols = idx // w, idx % w
    return rows, cols, angle(ori[torch.arange(b, device=ori.device), rows, cols])


def angle(vec: torch.Tensor) -> torch.Tensor:
    """(cos, sin) [..., 2] -> degrees in [0, 360)."""
    a = torch.rad2deg(torch.arccos(vec[..., 0].clamp(-1.0, 1.0)))
    return torch.where(vec[..., 1] < 0, torch.remainder(-a, 360.0), a)
