"""TF-style 'SAME' padding with the reference's static-224 quirk, and
horizontal-circular padding for 360-degree panoramas (the port of
ccvpe_tpu/ops/padding.py:25-96).

The reference computes every EfficientNet pad at construction from the
nominal ImageNet size 224, not from the real input, so each pad in B0 is a
fixed constant; an Oxford 154x231 ground image then gives a 4x7 feature map.
Stride-2 pads are asymmetric, e.g. (0, 1), and torch's Conv2d(padding=) is
symmetric only, so the port pads with F.pad before a padding-free conv.

Tensors here are NCHW (the JAX package's pad_same takes NHWC).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

# (kernel, stride) of every spatial conv in EfficientNet-B0, in order: the
# stem, then the depthwise conv of each of the 16 blocks.
B0_STEM = (3, 2)
B0_BLOCKS: Tuple[Tuple[int, int], ...] = (
    (3, 1),
    (3, 2), (3, 1),
    (5, 2), (5, 1),
    (3, 2), (3, 1), (3, 1),
    (5, 1), (5, 1), (5, 1),
    (5, 2), (5, 1), (5, 1), (5, 1),
    (3, 1),
)

Pad = Tuple[int, int]


def same_pad_1d(size: int, kernel: int, stride: int) -> Pad:
    """TF SAME pad (lo, hi) for one spatial dim (Conv2dStaticSamePadding)."""
    out = math.ceil(size / stride)
    pad = max((out - 1) * stride + kernel - size, 0)
    return pad // 2, pad - pad // 2


def traced_same_pads(image_size: Tuple[int, int] = (224, 224)
                     ) -> Tuple[Tuple[Pad, Pad], ...]:
    """Per-layer ((top, bottom), (left, right)) of the stem and the 16
    blocks, tracing the nominal image size through the strides as the
    reference does at construction."""
    h, w = image_size
    pads = []
    for k, s in (B0_STEM,) + B0_BLOCKS:
        pads.append((same_pad_1d(h, k, s), same_pad_1d(w, k, s)))
        h, w = math.ceil(h / s), math.ceil(w / s)
    return tuple(pads)


def b0_layer_sizes(input_size: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    """Output H, W of the stem and of each of the 16 blocks for a real input
    under the static-224 pads: floor((size + pad - kernel) / stride) + 1."""
    pads = traced_same_pads()
    h, w = input_size
    sizes = []
    for ((pt, pb), (pl, pr)), (k, s) in zip(pads, (B0_STEM,) + B0_BLOCKS):
        h = (h + pt + pb - k) // s + 1
        w = (w + pl + pr - k) // s + 1
        sizes.append((h, w))
    return tuple(sizes)


def b0_output_size(input_size: Tuple[int, int]) -> Tuple[int, int]:
    """Backbone output H, W for a real input under the static-224 pads."""
    return b0_layer_sizes(input_size)[-1]


def wrap_w(x: torch.Tensor, pad_w: Pad) -> torch.Tensor:
    """Circular pad of the last (W) axis by (left, right)."""
    left, right = pad_w
    parts = []
    if left:
        parts.append(x[..., x.shape[-1] - left:])
    parts.append(x)
    if right:
        parts.append(x[..., :right])
    return torch.cat(parts, dim=-1) if len(parts) > 1 else x


def pad_same(x: torch.Tensor, pad_h: Pad, pad_w: Pad,
             circular: bool = False) -> torch.Tensor:
    """Static padding of an NCHW tensor. circular=True wraps W and
    zero-pads H (Conv2dStaticCircularPadding)."""
    if circular:
        x = wrap_w(x, pad_w)
        pad_w = (0, 0)
    if pad_h == (0, 0) and pad_w == (0, 0):
        return x
    return F.pad(x, (*pad_w, *pad_h))
