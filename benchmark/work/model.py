"""The model FLOPs of one step: every matrix product and convolution of
the plain reference (benchmark/reference/) at the cell's shapes, counted by
torch.utils.flop_counter.FlopCounterMode on the meta device (no memory,
no arithmetic): the forward of a request; the forward and the backward of
a train step, with no recomputation. Elementwise work is not counted.

A convolution's backward is counted here as what it computes: the forward's
multiply-adds once for the input's gradient and once for the weight's,
each where it is wanted. (FlopCounterMode's own formula counts the weight
gradient of a grouped convolution as if it were dense, over a thousand
times too high for B0's depthwise convolutions.)"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import cvm, train


def conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                  transposed, _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    spatial = (x_shape if transposed else grad_out_shape)[2:]
    macs = x_shape[0] * math.prod(spatial) * math.prod(w_shape)
    return 2 * macs * (int(output_mask[0]) + int(output_mask[1]))


def step_flops(model: dict, train_cfg: dict, traffic: dict) -> int:
    b = traffic["batch"]
    meta = torch.device("meta")
    params = {n: torch.empty(shape, device=meta, dtype=torch.long if kind == "bn_n" else torch.float32)
              for n, (kind, shape) in cvm.param_shapes(model).items()}
    grd = torch.empty((b, *model["grd_size"], 3), dtype=torch.uint8, device=meta)
    sat = torch.empty((b, *model["sat_size"], 3), dtype=torch.uint8, device=meta)
    trained = [t.requires_grad_() for n, t in params.items() if t.is_floating_point()
               and not n.endswith(("running_mean", "running_var"))]
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.convolution_backward: conv_backward})
    with counter:
        if traffic["kind"] == "train":
            out = cvm.forward(params, model, grd, sat, train=True)
            off = torch.zeros(b, device=meta)
            loss = train.losses(model, train_cfg, out, off, off, off)
            torch.autograd.grad(loss, trained)
        else:
            with torch.no_grad():
                out = cvm.forward(params, model, grd, sat)
                cvm.decode(out.heatmap, out.ori)
    return counter.get_total_flops()
