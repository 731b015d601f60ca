"""On-device ground-truth rendering from (offset, angle) scalars (the port
of ccvpe_tpu/ops/gt.py:30-113).

The host ships three scalars per sample (row_offset, col_offset,
angle_deg) and the GT maps are rendered on the device, in float32. Bin
order is dataset-specific (SURVEY.md 2.3.9): VIGOR and KITTI count bins in
REVERSED order (index 0 -> (ch 0, ch K-1), index i > 0 -> (ch K-i,
ch K-i-1)), Oxford forward (wrapping at K-1). All outputs NHWC.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

SIGMA = 4.0  # Gaussian sigma in pixels (reference datasets.py:149)


def gaussian_heatmap(height: int, width: int, row_offset: torch.Tensor,
                     col_offset: torch.Tensor, sigma: float = SIGMA) -> torch.Tensor:
    """exp(-d^2 / 2 sigma^2) around (centre - row_offset, centre + col_offset)
    on the reference's inclusive-endpoint linspace grid (step w/(w-1)).
    Offsets [B]; returns [B, H, W, 1] float32."""
    dev = row_offset.device
    xs = torch.linspace(-width / 2.0, width / 2.0, width, device=dev)
    ys = torch.linspace(-height / 2.0, height / 2.0, height, device=dev)
    x = xs[None, None, :] + col_offset.float()[:, None, None]
    y = ys[None, :, None] - row_offset.float()[:, None, None]
    d2 = x * x + y * y
    return torch.exp(-d2 / (2.0 * sigma * sigma))[..., None]


def gaussian_heatmap_window(height: int, width: int, win: int, row0: torch.Tensor,
                            col0: torch.Tensor, row_offset: torch.Tensor,
                            col_offset: torch.Tensor, sigma: float = SIGMA) -> torch.Tensor:
    """gaussian_heatmap restricted to a per-sample [row0:row0+win,
    col0:col0+win] window (ModelConfig.ori_window): the same linspace
    coordinates gathered, so equal to the sliced full map bit for bit.
    row0/col0 [B] integer; returns [B, win, win, 1] float32."""
    dev = row_offset.device
    xs = torch.linspace(-width / 2.0, width / 2.0, width, device=dev)
    ys = torch.linspace(-height / 2.0, height / 2.0, height, device=dev)
    span = torch.arange(win, device=dev)
    xs_w = xs[col0.long()[:, None] + span]                  # [B, win]
    ys_w = ys[row0.long()[:, None] + span]
    x = xs_w[:, None, :] + col_offset.float()[:, None, None]
    y = ys_w[:, :, None] - row_offset.float()[:, None, None]
    d2 = x * x + y * y
    return torch.exp(-d2 / (2.0 * sigma * sigma))[..., None]


def orientation_bin_weights(angle_deg: torch.Tensor, num_bins: int,
                            reversed_order: bool) -> torch.Tensor:
    """Per-sample (1 - ratio, ratio) weights on the two bins next to the
    angle. angle_deg [B] in [0, 360); returns [B, K] float32."""
    angle = angle_deg.float()
    bin_deg = 360.0 / num_bins
    index = torch.floor(angle / bin_deg).long()
    ratio = torch.remainder(angle, bin_deg) / bin_deg
    if reversed_order:
        first = index == 0
        i0 = torch.where(first, torch.zeros_like(index), num_bins - index)
        i1 = torch.where(first, torch.full_like(index, num_bins - 1), num_bins - index - 1)
    else:
        i0 = index
        i1 = torch.remainder(index + 1, num_bins)
    oh0 = F.one_hot(i0, num_bins).float()
    oh1 = F.one_hot(i1, num_bins).float()
    return oh0 * (1.0 - ratio)[:, None] + oh1 * ratio[:, None]


def render_gt(height: int, width: int, num_bins: int, row_offset: torch.Tensor,
              col_offset: torch.Tensor, angle_deg: torch.Tensor,
              reversed_order: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gt [B,H,W,1], gt_with_ori [B,H,W,K], ori [B,H,W,2])."""
    gt = gaussian_heatmap(height, width, row_offset, col_offset)
    w = orientation_bin_weights(angle_deg, num_bins, reversed_order)
    gt_with_ori = gt * w[:, None, None, :]
    rad = angle_deg.float() * (math.pi / 180.0)
    ori = torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)
    ori = ori[:, None, None, :].expand(angle_deg.shape[0], height, width, 2)
    return gt, gt_with_ori, ori


def maxpool_pyramid(x: torch.Tensor, factors: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Non-overlapping max-pool of NHWC x by each integer factor (GT
    pyramid of the per-scale infoNCE, reference train_VIGOR.py:123-128)."""
    b, h, w, c = x.shape
    return tuple(x.reshape(b, h // f, f, w // f, f, c).amax(dim=(2, 4)) for f in factors)
