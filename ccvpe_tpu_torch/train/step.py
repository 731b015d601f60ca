"""Input normalization and the scalar-only eval step (the port of
ccvpe_tpu/train/step.py:39-52, 268-288). The train step comes with the
training slice.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ccvpe_tpu_torch.models.cvm import CVM
from ccvpe_tpu_torch.ops import pose

# ImageNet normalization constants (ccvpe_tpu/data/transforms.py)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def device_normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32; float32 passes through
    (already normalized on the host)."""
    if img.dtype != torch.uint8:
        return img
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img.float() / 255.0 - mean) / std


def make_eval_decode_step(model: CVM) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """Forward + pose decode + GT location + prob@GT, returning six [B]
    tensors (pred rows, cols, angle deg, GT rows, cols, prob@GT) on the
    model's device; the heatmap never leaves it. Inputs are NHWC tensors on
    that device, images uint8 or normalized f32, offsets [B]."""

    @torch.inference_mode()
    def step(grd, sat, row_offset, col_offset):
        out = model(device_normalize(grd), device_normalize(sat))
        rows, cols, angle = pose.decode_pose(out.heatmap, out.ori)
        hs, ws = out.heatmap.shape[1:3]
        gt_rows, gt_cols = pose.gt_location_device(hs, ws, row_offset, col_offset)
        b = out.heatmap.shape[0]
        idx = torch.arange(b, device=out.heatmap.device)
        prob_gt = out.heatmap[idx, gt_rows, gt_cols, 0]
        return rows, cols, angle, gt_rows, gt_cols, prob_gt

    return step
