"""TF-style 'SAME' padding with the reference's static-224 quirk, and
horizontal-circular padding for 360-degree panoramas (the port of
ccvpe_tpu/ops/padding.py:25-161): materialized ('wrap', `pad_same`) or as
a zero-padded conv whose wrap-crossing edge columns are recomputed
('edgefix', `conv_circular_same`).

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


def _conv(x: torch.Tensor, weight: torch.Tensor, stride: int, pad_h: Pad, pad_w: Pad,
          groups: int) -> torch.Tensor:
    """conv2d with zero padding (top, bottom) and (left, right): as the
    conv's own padding where each pair is symmetric, else by F.pad."""
    if pad_h[0] == pad_h[1] and pad_w[0] == pad_w[1]:
        return F.conv2d(x, weight, None, stride, (pad_h[0], pad_w[0]), groups=groups)
    return F.conv2d(F.pad(x, (*pad_w, *pad_h)), weight, None, stride, groups=groups)


def conv_circular_same(x: torch.Tensor, weight: torch.Tensor, stride: int, pad_h: Pad,
                       pad_w: Pad, groups: int = 1) -> torch.Tensor:
    """A bias-free conv of NCHW x with W wrapped by pad_w and H zero-padded
    by pad_h, without writing the wrapped tensor (circular_impl='edgefix'):
    the conv runs with zero W padding, then the <= 2 output columns a side
    whose window crosses the wrap are recomputed from small wrapped strips
    and put in their place. The edge convs read the windows the wrapped
    conv reads, so the values equal conv(pad_same(x, pad_h, pad_w,
    circular=True)) up to the order of each sum."""
    pl, pr = pad_w
    k = weight.shape[-1]
    w_in = x.shape[-1]
    y = _conv(x, weight, stride, pad_h, pad_w, groups)
    if pl == 0 and pr == 0:
        return y
    w_out = y.shape[-1]
    # output column j reads padded columns [j*s, j*s+k); padded column p is
    # input column p - pl, wrapped
    n_left = -(-pl // stride) if pl else 0
    j0_right = (pl + w_in - k) // stride + 1
    n_right = max(0, w_out - j0_right)
    if n_left + n_right > w_out:
        raise ValueError(f"W = {w_in} is too narrow for a {k}-wide window wrapped by {pad_w}")
    parts = []
    if n_left:
        span = (n_left - 1) * stride + k
        strip = torch.cat([x[..., w_in - pl:], x[..., :span - pl]], dim=-1)
        parts.append(_conv(strip, weight, stride, pad_h, (0, 0), groups))
    parts.append(y[..., n_left:w_out - n_right])
    if n_right:
        span = (n_right - 1) * stride + k
        start = j0_right * stride - pl
        wrap = span - (w_in - start)
        strip = x[..., start:]
        if wrap > 0:
            strip = torch.cat([strip, x[..., :wrap]], dim=-1)
        parts.append(_conv(strip, weight, stride, pad_h, (0, 0), groups))
    return torch.cat(parts, dim=-1)
