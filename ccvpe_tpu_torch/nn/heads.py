"""Descriptor heads (the port of ccvpe_tpu/nn/heads.py:25-72).

Ground head (reference models.py:57-62): Conv1x1(F -> C), permute so that
H lies on the channel axis, Conv1x1(H -> 1), flatten. The flatten order is
(w, c) — index w*C + c — which is what makes a channel roll of the sat
descriptor an azimuth rotation; a plain NCHW flatten would give (c, w).

Aerial head (models.py:102-104): one shared Linear(F*ch*cw -> D) over each
chunk of a grid x grid split of the bottleneck, each chunk flattened in
torch's (C, ch, cw) order.

Module names follow the reference state dict: grd_feature_to_descriptorN is
Sequential(compress conv, permute, h conv) -> .0 / .2; the sat head is
Sequential(Flatten, Linear) -> .1.

Both heads compute in float32 whatever their input's dtype: flax's Conv
and Dense there have no dtype and promote bf16 features to their float32
parameters.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class _PermuteHToChannels(nn.Module):
    """[B, C, H, W] -> [B, H, W, C] read as NCHW with H as channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1)


class GroundDescriptorHead(nn.Sequential):
    """[B, F, H, W] -> [B, W*C] in (w, c) order."""

    def __init__(self, in_features: int, channels: int, height: int):
        super().__init__(
            nn.Conv2d(in_features, channels, 1),    # compress
            _PermuteHToChannels(),
            nn.Conv2d(height, 1, 1),                 # contract H, scalar bias
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).flatten(1)    # [B, 1, W, C] -> (w, c)


class SatDescriptorHead(nn.Sequential):
    """[B, F, gh, gw] -> [B, grid, grid, D] (NHWC chunk descriptor map)."""

    def __init__(self, in_features: int, chunk_hw: int, out_dim: int, grid: int):
        super().__init__(nn.Flatten(), nn.Linear(in_features * chunk_hw, out_dim))
        self.grid = grid

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        b, f, gh, gw = x.shape
        g = self.grid
        ch, cw = gh // g, gw // g
        x = x.reshape(b, f, g, ch, g, cw).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, g, g, f * ch * cw)         # (C, ch, cw) per chunk
        return self[1](x)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2) semantics, x / max(||x||, eps), in float32."""
    x = x.float()
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / n.clamp_min(eps)
