"""Pose decoding and evaluation metrics (the port of
ccvpe_tpu/ops/pose.py:23-109).

Device part in torch: argmax of the heatmap (first maximum on ties, as
jnp.argmax and torch.argmax both give) and the orientation field sampled
there. Aggregation is host numpy, copied as it is.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def decode_pose(heatmap: torch.Tensor, ori: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B,H,W,1] heatmap + [B,H,W,2] ori field -> (rows [B], cols [B],
    angle_deg [B]) at the heatmap argmax."""
    b, h, w, _ = heatmap.shape
    idx = torch.argmax(heatmap.reshape(b, -1), dim=-1)
    rows, cols = idx // w, idx % w
    vec = ori[torch.arange(b, device=ori.device), rows, cols]   # [B, 2]
    return rows, cols, decode_angle(vec[:, 0], vec[:, 1])


def decode_angle(cos_v: torch.Tensor, sin_v: torch.Tensor) -> torch.Tensor:
    """acos + sin-sign decode, mod 360. (-a) mod 360 is torch.remainder,
    whose sign follows the divisor as Python's % does; torch.fmod would not."""
    a = torch.rad2deg(torch.arccos(torch.clamp(cos_v, -1.0, 1.0)))
    return torch.where(sin_v < 0, torch.remainder(-a, 360.0), a)


def _linspace64(n: int, device) -> torch.Tensor:
    """np.linspace(-n/2, n/2, n) to the bit, on `device`: i * step + start
    in float64, the last point set to the end, as numpy computes it (by
    masked_fill, a kernel that takes the value as an argument, which a CUDA
    graph can capture)."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (i * (n / (n - 1)) + (-n / 2.0)).masked_fill(i == n - 1, n / 2.0)


def gt_location_device(height: int, width: int, row_offset: torch.Tensor,
                       col_offset: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch twin of gt_location, on the host's float64 grid, so the two
    agree at offsets halfway between grid points (first minimum on ties).
    The JAX twin builds its grid in float32, which can round such a tie the
    other way; the host function is the reference."""
    dev = row_offset.device
    ys, xs = _linspace64(height, dev), _linspace64(width, dev)
    rows = torch.argmin(torch.abs(ys[None, :] - row_offset.double()[:, None]), dim=1)
    cols = torch.argmin(torch.abs(xs[None, :] + col_offset.double()[:, None]), dim=1)
    return rows, cols


def angle_error(pred_deg: np.ndarray, gt_deg: np.ndarray) -> np.ndarray:
    d = np.abs(pred_deg - gt_deg)
    return np.minimum(d, 360.0 - d)


def gt_location(height: int, width: int, row_offset: np.ndarray,
                col_offset: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Argmax of the GT Gaussian = nearest point of the inclusive-endpoint
    linspace grid to the offset centre (reference datasets.py:147)."""
    ys = np.linspace(-height / 2.0, height / 2.0, height)
    xs = np.linspace(-width / 2.0, width / 2.0, width)
    rows = np.abs(ys[None, :] - row_offset[:, None]).argmin(axis=1)
    cols = np.abs(xs[None, :] + col_offset[:, None]).argmin(axis=1)
    return rows, cols


def longitudinal_lateral(
    pixel_rows: np.ndarray, pixel_cols: np.ndarray,
    gt_rows: np.ndarray, gt_cols: np.ndarray,
    heading_deg: np.ndarray, meters_per_pixel: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Project the error vector onto the vehicle direction (reference
    train_KITTI.py:320-327); `heading_deg` is the GT orientation from North."""
    drow = np.abs(gt_rows - pixel_rows)
    dcol = np.abs(gt_cols - pixel_cols)
    dist = np.sqrt(drow ** 2 + dcol ** 2) * meters_per_pixel
    err_dir = np.degrees(np.arctan2(dcol, drow))
    diff = np.radians(np.abs(heading_deg - err_dir))
    return np.abs(np.cos(diff)) * dist, np.abs(np.sin(diff)) * dist


def summarize(distances: np.ndarray, ori_errors: Optional[np.ndarray] = None,
              prob_at_gt: Optional[np.ndarray] = None) -> Dict[str, float]:
    out = {
        "mean_distance_m": float(np.mean(distances)),
        "median_distance_m": float(np.median(distances)),
    }
    if ori_errors is not None and len(ori_errors):
        out["mean_ori_deg"] = float(np.mean(ori_errors))
        out["median_ori_deg"] = float(np.median(ori_errors))
    if prob_at_gt is not None and len(prob_at_gt):
        out["mean_prob_at_gt"] = float(np.mean(prob_at_gt))
        out["median_prob_at_gt"] = float(np.median(prob_at_gt))
    return out


def recalls(errors_m: np.ndarray, thresholds=(1.0, 3.0, 5.0)) -> Dict[str, float]:
    """Recall@threshold (reference train_KITTI.py:358-360)."""
    return {f"recall@{t:g}": float(np.mean(errors_m < t)) for t in thresholds}
