"""Training losses (the port of ccvpe_tpu/train/losses.py:17-52; reference
losses.py:4-29). infoNCE is the where-weighted dense form of the
reference's masked_select, in log space. Maps NHWC; scores flattened to
[B, N]."""

from __future__ import annotations

import torch


def infonce_loss(scores: torch.Tensor, labels: torch.Tensor,
                 temperature: float = 0.1,
                 global_negatives: bool = False) -> torch.Tensor:
    """-sum_i w_i log softmax(s/T)_i / sum_i w_i over the positives
    (labels > 1e-2, weighted by the label). The softmax denominator is per
    sample, as in the reference; global_negatives pools it over the batch."""
    z = scores / temperature
    if global_negatives:
        logp = z - torch.logsumexp(z.reshape(-1), dim=0)
    else:
        logp = torch.log_softmax(z, dim=1)
    w = torch.where(labels > 1e-2, labels, torch.zeros_like(labels))
    return -(w * logp).sum() / w.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Soft-label CE over the flattened heatmap; labels are the
    sum-normalised Gaussian GT."""
    return -(labels * torch.log_softmax(logits, dim=1)).sum() / logits.shape[0]


def orientation_loss(ori: torch.Tensor, gt_orientation: torch.Tensor,
                     gt: torch.Tensor) -> torch.Tensor:
    """Squared (cos, sin) error weighted per pixel by the Gaussian GT.
    ori, gt_orientation [B,H,W,2], gt [B,H,W,1]."""
    sq = (gt_orientation - ori).square().sum(dim=-1, keepdim=True)
    return (sq * gt).sum() / ori.shape[0]
