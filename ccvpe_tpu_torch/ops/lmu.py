"""The fused LMU decoder stage, plain PyTorch (the math of
ccvpe_tpu/ops/lmu_pallas.py::fused_stage_reference, :729, and the eight
outputs of fused_stage_bwd_pallas, :515).

One stage (reference models.py:108-127, 204-341) is

    y = conv3x3(relu(conv3x3(concat[deconv2x2(x), skip], w1) + b1), w2) + b2

with skip=None for the final stage, whose second half is the head. These
are the oracles of the CUDA kernels in ops/lmu_cuda.py (csrc/lmu.cu) and
what their wrappers run on a CPU tensor.

Activations are NHWC (x [B,Hc,Wc,Cin], skip [B,2Hc,2Wc,Cs], y
[B,2Hc,2Wc,Cout], float32); weights are in torch's layouts, those of the
modules they come from: wd (Cin, Cd, 2, 2) of ConvTranspose2d, w1
(C1, Cd+Cs, 3, 3) and w2 (Cout, C1, 3, 3) of Conv2d.

A bf16 x takes the TPU kernels' bf16 policy (lmu_pallas.py casts to
x.dtype, :332, :527): skip, dy and the weights rounded to bf16, biases
float32; h = deconv + bd (:251) and conv_a + b1 (:192) rounded before the
ReLU; in the backward da after the mask (:465), dh for dx and dwd but not
for dbd (:483-488), dx and dskip as they are returned (:491-492); products
of those bf16 values are exact and every sum is float32, so y and the
weight and bias gradients are float32 and dx and dskip bf16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (nearest even), kept as float32."""
    return t.to(torch.bfloat16).float()


def fused_stage_plain(x: torch.Tensor, skip: Optional[torch.Tensor],
                      wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """deconv2x2 [+ skip concat] + conv3x3 + relu + conv3x3, NHWC in and out."""
    if x.dtype == torch.bfloat16:
        return _fused_stage_plain_bf16(x, skip, wd, bd, w1, b1, w2, b2)
    h = F.conv_transpose2d(x.permute(0, 3, 1, 2).float(), wd, bd, stride=2)
    if skip is not None:
        h = torch.cat([h, skip.permute(0, 3, 1, 2).float()], dim=1)
    g = F.relu(F.conv2d(h, w1, b1, padding=1))
    return F.conv2d(g, w2, b2, padding=1).permute(0, 2, 3, 1)


def fused_stage_bwd_plain(x: torch.Tensor, skip: Optional[torch.Tensor], dy: torch.Tensor,
                          wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
                          ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dx, dskip or None, dwd, dbd, dw1, db1, dw2, db2) of fused_stage_plain
    for the cotangent dy [B,2Hc,2Wc,Cout], by autograd of the plain chain
    recomputed from the inputs (nothing of the forward is kept); a bf16 x
    under the bf16 policy, conv by conv."""
    if x.dtype == torch.bfloat16:
        with torch.no_grad():
            return _fused_stage_bwd_plain_bf16(x, skip, dy, wd, bd, w1, b1, w2)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, wd, bd, w1, b1, w2, b2)]
        s = None if skip is None else skip.detach().requires_grad_()
        xx, wwd, bbd, ww1, bb1, ww2, bb2 = leaves
        y = fused_stage_plain(xx, s, wwd, bbd, ww1, bb1, ww2, bb2)
        inputs = [xx] + ([s] if s is not None else []) + leaves[1:]
        grads = torch.autograd.grad(y, inputs, dy)
    if s is None:
        grads = (grads[0], None) + tuple(grads[1:])
    return tuple(grads)


def _bf16_chain(x, skip, wd, bd, w1, b1):
    """The bf16 policy's forward up to conv_a, NCHW float32 tensors of bf16
    values: (rounded weights wd, w1, [h | skip], a = conv_a + b1 unrounded,
    g = relu(rounded a))."""
    wd, w1 = round_bf16(wd.detach()), round_bf16(w1.detach())
    h = round_bf16(F.conv_transpose2d(x.permute(0, 3, 1, 2).float(), wd, bd.detach(), stride=2))
    if skip is not None:
        h = torch.cat([h, round_bf16(skip.permute(0, 3, 1, 2).float())], dim=1)
    a = F.conv2d(h, w1, b1.detach(), padding=1)
    return wd, w1, h, a, F.relu(round_bf16(a))


def _fused_stage_plain_bf16(x, skip, wd, bd, w1, b1, w2, b2):
    """fused_stage_plain under the bf16 policy: y float32."""
    _, _, _, _, g = _bf16_chain(x, skip, wd, bd, w1, b1)
    return F.conv2d(g, round_bf16(w2.detach()), b2.detach(), padding=1).permute(0, 2, 3, 1)


def _fused_stage_bwd_plain_bf16(x, skip, dy, wd, bd, w1, b1, w2):
    """fused_stage_bwd_plain under the bf16 policy, as the TPU kernel's
    backward computes it (lmu_pallas.py:404-512): each conv's input and
    weight gradient from the rounded cotangents, the ReLU mask from the
    unrounded conv_a."""
    b, hc, wc, cin = x.shape
    cd = wd.shape[1]
    wd, w1, h, a, g = _bf16_chain(x, skip, wd, bd, w1, b1)
    w2 = round_bf16(w2.detach())
    dy = round_bf16(dy.permute(0, 3, 1, 2).float())
    da = round_bf16(torch.where(a > 0, conv2d_input(g.shape, w2, dy, padding=1),
                                torch.zeros_like(a)))
    dhs = conv2d_input(h.shape, w1, da, padding=1)
    dh = dhs[:, :cd]
    dhr = round_bf16(dh)
    dx = F.conv2d(dhr, wd, stride=2)
    dwd = torch.einsum("bchw,bohpwq->copq", x.permute(0, 3, 1, 2).float(),
                       dhr.reshape(b, cd, hc, 2, wc, 2))
    dskip = None
    if skip is not None:
        dskip = dhs[:, cd:].permute(0, 2, 3, 1).to(torch.bfloat16)
    return (dx.permute(0, 2, 3, 1).to(torch.bfloat16), dskip, dwd, dh.sum((0, 2, 3)),
            conv2d_weight(h, w1.shape, da, padding=1), da.sum((0, 2, 3)),
            conv2d_weight(g, w2.shape, dy, padding=1), dy.sum((0, 2, 3)))
