"""Training losses (the port of ccvpe_tpu/train/losses.py:17-52; reference
losses.py:4-29). infoNCE is the where-weighted dense form of the
reference's masked_select, in log space. Maps NHWC; scores flattened to
[B, N].

Each loss is the global batch's, as under the JAX package's jit over a
batch sharded on 'data': across a data axis of D processes (core/mesh.py)
its sums are global sums over the data group (mesh.global_sum) and its
batch the global one (D * B rows; the model ranks of a data index hold
the same rows); on a data axis of size 1 the single-process expressions,
with the same bits."""

from __future__ import annotations

import torch

from ccvpe_tpu_torch.core import mesh


def _global_rows(t: torch.Tensor) -> int:
    return t.shape[0] * mesh.data_size()


def infonce_loss(scores: torch.Tensor, labels: torch.Tensor,
                 temperature: float = 0.1,
                 global_negatives: bool = False) -> torch.Tensor:
    """-sum_i w_i log softmax(s/T)_i / sum_i w_i over the positives
    (labels > 1e-2, weighted by the label). The softmax denominator is per
    sample, as in the reference; global_negatives pools it over the global
    batch (logsumexp as a global max, then a global sum of exponentials)."""
    z = scores / temperature
    if not global_negatives:
        logp = torch.log_softmax(z, dim=1)
    elif mesh.data_size() == 1:
        logp = z - torch.logsumexp(z.reshape(-1), dim=0)
    else:
        m = mesh.global_max(z.max())
        logp = z - (m + torch.log(mesh.global_sum(torch.exp(z - m).sum())))
    w = torch.where(labels > 1e-2, labels, torch.zeros_like(labels))
    sums = mesh.global_sum(torch.stack([(w * logp).sum(), w.sum()]))
    return -sums[0] / sums[1]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Soft-label CE over the flattened heatmap; labels are the
    sum-normalised Gaussian GT."""
    return -mesh.global_sum((labels * torch.log_softmax(logits, dim=1)).sum()) / _global_rows(
        logits)


def orientation_loss(ori: torch.Tensor, gt_orientation: torch.Tensor,
                     gt: torch.Tensor) -> torch.Tensor:
    """Squared (cos, sin) error weighted per pixel by the Gaussian GT.
    ori, gt_orientation [B,H,W,2], gt [B,H,W,1]."""
    sq = (gt_orientation - ori).square().sum(dim=-1, keepdim=True)
    return mesh.global_sum((sq * gt).sum()) / _global_rows(ori)
