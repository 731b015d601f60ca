"""Localization / orientation decoder stages (the port of
ccvpe_tpu/nn/decoder.py:28-116, 137-204, plain and fused paths).

One LMU stage (reference models.py:204-341): ConvTranspose2d(k=2, s=2),
concat the aerial skip features (stages 1-5), then Conv3x3 -> ReLU ->
Conv3x3. The final stage's deconv feeds a head of the same shape with 1
(localization) or 2 (orientation) output channels. The plain path stays
PyTorch / cuDNN ops, as it is XLA ops in the JAX package; the fused path
(`fused_stage_nchw`, ModelConfig.lmu_fused_min_res) runs the stage as one
autograd.Function over the hand-written kernels of ops/lmu_cuda.py, with
the modules' own weights, so state dicts load either way. Tensors are NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ccvpe_tpu_torch.ops.lmu_cuda import FusedStage


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


def fused_stage_nchw(deconv: Deconv2x2, conv: DoubleConv, x: torch.Tensor,
                     skip: Optional[torch.Tensor]) -> torch.Tensor:
    """deconv -> [| skip] -> conv (a DoubleConv, or the HeadConv of the final
    stage) as one fused stage; NCHW in and out, channels_last memory, f32."""
    cl = torch.channels_last
    xn = x.float().contiguous(memory_format=cl).permute(0, 2, 3, 1)
    sn = None if skip is None else skip.float().contiguous(memory_format=cl).permute(0, 2, 3, 1)
    y = FusedStage.apply(xn, sn, deconv.weight, deconv.bias, conv[0].weight, conv[0].bias,
                         conv[2].weight, conv[2].bias)
    return y.permute(0, 3, 1, 2)


def decoder_stage(deconv: Deconv2x2, conv: Optional[DoubleConv],
                  x: torch.Tensor, skip: Optional[torch.Tensor],
                  fused: bool = False) -> torch.Tensor:
    """DecoderStage: deconv -> optional [deconv | skip] concat -> optional
    double conv (None for the final stage, whose head is applied outside).
    fused=True runs a stage with its double conv through fused_stage_nchw."""
    if fused and conv is not None:
        return fused_stage_nchw(deconv, conv, x, skip)
    x = deconv(x)
    if skip is not None:
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
    if conv is not None:
        x = conv(x)
    return x
