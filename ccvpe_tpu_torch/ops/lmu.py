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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def fused_stage_plain(x: torch.Tensor, skip: Optional[torch.Tensor],
                      wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """deconv2x2 [+ skip concat] + conv3x3 + relu + conv3x3, NHWC in and out."""
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
    recomputed from the inputs (nothing of the forward is kept)."""
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
