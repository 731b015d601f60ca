"""Localization / orientation decoder stages (the port of
ccvpe_tpu/nn/decoder.py:28-116, 137-204, plain path).

One LMU stage (reference models.py:204-341): ConvTranspose2d(k=2, s=2),
concat the aerial skip features (stages 1-5), then Conv3x3 -> ReLU ->
Conv3x3. The final stage's deconv feeds a head of the same shape with 1
(localization) or 2 (orientation) output channels. These stay PyTorch /
cuDNN ops, as they are XLA ops in the JAX package. Tensors are NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class Deconv2x2(nn.ConvTranspose2d):
    """ConvTranspose2d(in, out, kernel=2, stride=2). The reference weight
    layout (in, out, 2, 2) is used as it is: a zero-overlap transposed conv
    indexes out[2i+di, 2j+dj] with w[:, :, di, dj], no flip."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, kernel_size=2, stride=2)


class DoubleConv(nn.Sequential):
    """Conv3x3(pad 1) -> ReLU -> Conv3x3(pad 1); parameters .0 and .2."""

    def __init__(self, cin: int, hidden: int, cout: Optional[int] = None):
        super().__init__(
            nn.Conv2d(cin, hidden, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(hidden, hidden if cout is None else cout, 3, padding=1),
        )


class HeadConv(DoubleConv):
    """Final head Conv3x3 -> ReLU -> Conv3x3 to `cout` channels, f32 out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).float()


def decoder_stage(deconv: Deconv2x2, conv: Optional[DoubleConv],
                  x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
    """DecoderStage: deconv -> optional [deconv | skip] concat -> optional
    double conv (None for the final stage, whose head is applied outside)."""
    x = deconv(x)
    if skip is not None:
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
    if conv is not None:
        x = conv(x)
    return x
