"""Localization / orientation decoder stages (the port of
ccvpe_tpu/nn/decoder.py:28-116, 137-204, plain and fused paths).

One LMU stage (reference models.py:204-341): ConvTranspose2d(k=2, s=2),
concat the aerial skip features (stages 1-5), then Conv3x3 -> ReLU ->
Conv3x3. The final stage's deconv feeds a head of the same shape with 1
(localization) or 2 (orientation) output channels. The plain path stays
PyTorch / cuDNN ops, as it is XLA ops in the JAX package; the fused path
(`fused_stage_nchw`, ModelConfig.lmu_fused_min_res) runs the stage as one
registered op over the hand-written kernels of ops/lmu_cuda.py (the
forward kernel, its registered backward the backward kernel), and
the phase path (ModelConfig.phase_space_min_res) on 2x2 packed maps
(ops/phase_space.py; the final stage hands its packed deconv output to a
packed head), each with the modules' own weights, so state dicts load any
way. Under ModelConfig.spatial_axis a stage can run on one model rank's
row block of the map (`decoder_stage_rows`, halo exchange for the 3x3
convs). Tensors are NCHW.

Mixed precision (ModelConfig.compute_dtype) as in the JAX package: the
deconv gives float32 (rounded per `impl`, see Deconv2x2), the skip concat
is float32, and the double conv and the head compute in `compute_dtype`
(conv outputs and biases in it); the head returns float32. A fused stage
takes its activations in `compute_dtype` (the bf16 kernels under
bfloat16) and returns `compute_dtype` (float32 from the head), as
nn/decoder.py:97-115 of the JAX package casts it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.nn.efficientnet import Conv2d
from ccvpe_tpu_torch.ops.lmu_cuda import fused_stage
from ccvpe_tpu_torch.ops.phase_space import conv3x3_packed, depth_to_space, phase_stage


class Deconv2x2(nn.ConvTranspose2d):
    """ConvTranspose2d(in, out, kernel=2, stride=2). The reference weight
    layout (in, out, 2, 2) is used as it is: a zero-overlap transposed conv
    indexes out[2i+di, 2j+dj] with w[:, :, di, dj], no flip.

    Float32 out for both impls of the JAX package (nn/decoder.py:28-64),
    which are one function in float32. In bfloat16 they round differently:
    'einsum' multiplies the bf16-rounded input and weight with float32
    sums (here the float32 conv of the rounded operands: the products are
    exact), 'conv' rounds the bf16 transposed conv's output, then adds the
    float32 bias."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype = torch.float32,
                 impl: str = "einsum"):
        super().__init__(cin, cout, kernel_size=2, stride=2)
        self.compute_dtype, self.impl = compute_dtype, impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.impl == "conv" and dt != torch.float32:
            y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, stride=2)
            return y.float() + self.bias[:, None, None]
        return F.conv_transpose2d(x.to(dt).float(), self.weight.to(dt).float(), self.bias,
                                  stride=2)


class DoubleConv(nn.Sequential):
    """Conv3x3(pad 1) -> ReLU -> Conv3x3(pad 1) in `compute_dtype`;
    parameters .0 and .2."""

    def __init__(self, cin: int, hidden: int, cout: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(
            Conv2d(cin, hidden, 3, padding=1),
            nn.ReLU(),
            Conv2d(hidden, hidden if cout is None else cout, 3, padding=1),
        )
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.compute_dtype))

    def forward_rows(self, x: torch.Tensor) -> torch.Tensor:
        """forward on this model rank's row block of the map (ModelConfig.
        spatial_axis): each conv takes a one-row halo from the neighbouring
        blocks (zero rows at the image's top and bottom,
        core/mesh.py::halo_rows) and pads the columns only, so the block
        of the whole map's output, in the same arithmetic. Each conv has
        its own halo, so the intermediate's rows outside the image are the
        second conv's zero padding, not relu(bias)."""
        x = x.to(self.compute_dtype)
        for i in (0, 2):
            conv = self[i]
            bias = conv.bias.to(x.dtype)
            x = F.conv2d(mesh.halo_rows(x), conv.weight.to(x.dtype), bias, padding=(0, 1))
            if i == 0:
                x = F.relu(x)
        return x


class HeadConv(DoubleConv):
    """Final head Conv3x3 -> ReLU -> Conv3x3 to `cout` channels, float32 out.
    packed=True takes the final stage's packed deconv output [B, 4*cin, H,
    W] and runs both convs packed (ops/phase_space.py), unpacking only the
    output."""

    def forward(self, x: torch.Tensor, packed: bool = False) -> torch.Tensor:
        if not packed:
            return super().forward(x).float()
        dt = self.compute_dtype
        g = conv3x3_packed(x.to(dt), self[0].weight, self[0].bias).to(dt)
        y = conv3x3_packed(F.relu(g), self[2].weight, self[2].bias)
        return depth_to_space(y, self[2].out_channels).float()

    def forward_rows(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward_rows(x).float()


def fused_stage_nchw(deconv: Deconv2x2, conv: DoubleConv, x: torch.Tensor,
                     skip: Optional[torch.Tensor]) -> torch.Tensor:
    """deconv -> [| skip] -> conv (a DoubleConv, or the HeadConv of the final
    stage) as one fused stage; NCHW in and out, channels_last memory; the
    activations in conv's compute_dtype, float32 out of a HeadConv, else
    compute_dtype."""
    cl, dt = torch.channels_last, conv.compute_dtype
    xn = x.to(dt).contiguous(memory_format=cl).permute(0, 2, 3, 1)
    sn = None if skip is None else skip.to(dt).contiguous(memory_format=cl).permute(0, 2, 3, 1)
    y = fused_stage(xn, sn, deconv.weight, deconv.bias, conv[0].weight, conv[0].bias,
                    conv[2].weight, conv[2].bias).permute(0, 3, 1, 2)
    return y if isinstance(conv, HeadConv) else y.to(dt)


def decoder_stage(deconv: Deconv2x2, conv: Optional[DoubleConv],
                  x: torch.Tensor, skip: Optional[torch.Tensor],
                  fused: bool = False, phase: bool = False) -> torch.Tensor:
    """DecoderStage: deconv -> optional [deconv | skip] concat -> optional
    double conv (None for the final stage, whose head is applied outside).
    fused=True runs a stage with its double conv through fused_stage_nchw;
    phase=True runs it in phase space (the final stage: its packed deconv
    output, for HeadConv(packed=True))."""
    if phase:
        ws = (None,) * 4 if conv is None else (conv[0].weight, conv[0].bias, conv[2].weight,
                                               conv[2].bias)
        return phase_stage(x, skip, deconv.weight, deconv.bias, *ws,
                           dtype=deconv.compute_dtype, unpack=conv is not None)
    if fused and conv is not None:
        return fused_stage_nchw(deconv, conv, x, skip)
    x = deconv(x)
    if skip is not None:
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
    if conv is not None:
        x = conv(x)
    return x


def decoder_stage_rows(deconv: Deconv2x2, conv: Optional[DoubleConv],
                       x: torch.Tensor, skip: Optional[torch.Tensor]) -> torch.Tensor:
    """decoder_stage on this model rank's row block x (ModelConfig.
    spatial_axis): the 2x2 deconv is local (output rows 2i and 2i+1 read
    input row i only), `skip` is the skip map's rows of the output block,
    and the double conv exchanges halos (DoubleConv.forward_rows)."""
    x = deconv(x)
    if skip is not None:
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
    if conv is not None:
        x = conv.forward_rows(x)
    return x
