"""EfficientNet-B0 feature extractor (the port of
ccvpe_tpu/nn/efficientnet.py:32-256), eval and train mode.

stem conv s2 -> 16 MBConv blocks -> 1x1 head conv to 1280 channels; each
MBConv = [expand 1x1 + BN + swish] -> depthwise conv + BN + swish -> SE ->
project 1x1 + BN -> drop-connect + residual. Every spatial conv uses the
static-224 SAME pads (ops/padding.py); the ground branch wraps W for
360-degree panoramas.

Module and parameter names are the reference's efficientnet_pytorch names
(_conv_stem, _bn0, _blocks.N._{expand,depthwise,project}_conv, _se_reduce,
_se_expand, _conv_head, _bn1), so a reference state dict loads as it is.

Train mode follows flax, the reference of the port: BatchNorm normalises
with the batch statistics and updates its running stats as
0.99 * old + 0.01 * batch with the BIASED batch variance (torch's own
update takes the unbiased one). Drop-connect (stochastic depth) at rate
DROP_CONNECT_RATE * i / 16 for block i draws its per-sample masks from
the torch.Generator the caller passes, each block's uniforms before the
block runs.

Mixed precision follows the JAX package's casts (compute_dtype bfloat16):
the input is cast once, every conv computes in its input's dtype with its
float32 weights cast per call, BatchNorm keeps its statistics and running
stats in float32 and returns its input's dtype, the SE gate's sigmoid runs
in float32, the residual is added in the block's dtype.

Across processes (core/mesh.py, world size N > 1) train mode is the
global batch's, as under the JAX package's jit over a batch sharded on
'data': BatchNorm's moments are those of every process's rows, from each
process's count, mean and biased variance (one float32 all-reduce,
differentiable, so the backward runs through them; combined as
torch.nn.SyncBatchNorm combines them, where a sum of squares less the
squared mean, flax's fast variance, loses the digits of a channel whose
mean is large against its spread), with flax's biased-variance EMA, the
same on every process; and
each block's drop-connect uniforms are drawn for the whole batch from the
one generator, every process keeping its own rows. At world size 1 both
take the single-process code.

Remat (ModelConfig.remat_backbone): blocks from index `remat_skip` on run
under torch.utils.checkpoint, 'save_dw' as two checkpointed segments split
at the depthwise conv's output (JAX's checkpoint_name "dw_out"), so that
output is kept and the rest recomputed. The recompute leaves the running
stats alone (flax's remat is functional and has no such update to repeat),
and the drop-connect uniforms are drawn outside the checkpointed region,
so remat on and off update the stats once and draw the same masks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.ops.padding import Pad, conv_circular_same, pad_same, traced_same_pads

# Per-block (expand_ratio, input_filters, output_filters, kernel, stride).
B0_BLOCK_SPECS: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 32, 16, 3, 1),
    (6, 16, 24, 3, 2), (6, 24, 24, 3, 1),
    (6, 24, 40, 5, 2), (6, 40, 40, 5, 1),
    (6, 40, 80, 3, 2), (6, 80, 80, 3, 1), (6, 80, 80, 3, 1),
    (6, 80, 112, 5, 1), (6, 112, 112, 5, 1), (6, 112, 112, 5, 1),
    (6, 112, 192, 5, 2), (6, 192, 192, 5, 1), (6, 192, 192, 5, 1), (6, 192, 192, 5, 1),
    (6, 192, 320, 3, 1),
)
SE_RATIO = 0.25
BN_EPS = 1e-3
BN_MOMENTUM = 0.01   # torch convention; flax's 0.99
DROP_CONNECT_RATE = 0.2

# set while checkpoint_block recomputes a block on this thread (the
# backward's): BatchNorm then leaves its running stats alone
_recompute = threading.local()


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running-stat update uses the biased
    batch variance, as flax's BatchNorm does. Statistics in float32 for any
    input dtype; the output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if mesh.world_size() > 1:
            return self._global_batch(x)
        # normalisation with batch statistics (biased variance, as torch
        # and flax both normalise); running stats left to the update below
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if not getattr(_recompute, "active", False):
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
                self._update_running(mean, var)
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the processes' rows together: each process's
        count, mean and biased variance (two-pass, as one process takes
        them) in its row of an [N, 2C + 1] table that one differentiable
        all-reduce (mesh.global_sum) fills on every process, then the
        global moments by the parallel-variance formula, in rank order, so
        the same bits on every process; the EMA from them."""
        c = x.shape[1]
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        count = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        row = torch.cat([count, mean, var])
        zeros = torch.zeros_like(row)
        table = mesh.global_sum(torch.stack([row if r == mesh.rank() else zeros
                                             for r in range(mesh.world_size())]))
        counts = table[:, :1]
        total = counts.sum()
        mean = (counts * table[:, 1:c + 1]).sum(dim=0) / total
        var = (counts * (table[:, c + 1:] + (table[:, 1:c + 1] - mean).square())).sum(dim=0) / total
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        if not getattr(_recompute, "active", False):
            with torch.no_grad():
                self._update_running(mean.detach(), var.detach())
        return y.to(x.dtype)


def batch_norm(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def drop_connect_uniforms(x: torch.Tensor,
                          generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[0, 1) per sample of x, [B, 1, 1, 1] in x's dtype, from `generator`;
    across N processes those of the rows of the global batch [N * B] that
    this process holds (the one generator's draws, as one process draws
    them for the global batch)."""
    if generator is None:
        raise ValueError("train-mode drop-connect needs a torch.Generator")
    b, n = x.shape[0], mesh.world_size()
    u = torch.rand((n * b, 1, 1, 1), generator=generator, device=x.device, dtype=x.dtype)
    return u if n == 1 else u[mesh.rank() * b:(mesh.rank() + 1) * b]


def apply_drop_connect(x: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """Per-sample stochastic depth (reference utils.py:129-154):
    x / keep * floor(keep + u)."""
    keep = 1.0 - rate
    return x / keep * torch.floor(keep + u)


@contextlib.contextmanager
def _recomputing():
    prev, _recompute.active = getattr(_recompute, "active", False), True
    try:
        yield
    finally:
        _recompute.active = prev


def checkpoint_block(fn, *args):
    """fn(*args) under torch.utils.checkpoint (non-reentrant): its
    intermediates are dropped and recomputed in the backward. The recompute
    runs with BatchNorm's running-stat update off: the forward made it."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in its input's dtype: the float32 weight and
    bias are cast per call (a no-op in float32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class StaticSameConv2d(Conv2d):
    """Bias-free conv with the fixed static-224 SAME pads applied by F.pad
    (asymmetric for stride 2), W wrapped when circular: by a wrapped copy
    of the input ('wrap'), or by recomputing the edge columns
    ('edgefix', ops/padding.py::conv_circular_same; the JAX package's
    CircularSameConv). The parameters are the same either way."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 pad_h: Pad, pad_w: Pad, circular: bool, groups: int = 1,
                 circular_impl: str = "wrap"):
        super().__init__(cin, cout, kernel, stride, padding=0, groups=groups,
                         bias=False)
        self.pad_h, self.pad_w, self.circular = pad_h, pad_w, circular
        self.edgefix = circular and circular_impl == "edgefix"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.edgefix:
            return conv_circular_same(x, self.weight.to(x.dtype), self.stride[0], self.pad_h,
                                      self.pad_w, self.groups)
        return super().forward(pad_same(x, self.pad_h, self.pad_w, self.circular))


class MBConv(nn.Module):
    """Mobile inverted bottleneck block."""

    def __init__(self, expand_ratio: int, in_filters: int, out_filters: int,
                 kernel: int, stride: int, pad_h: Pad, pad_w: Pad,
                 circular: bool, drop_rate: float = 0.0, circular_impl: str = "wrap"):
        super().__init__()
        mid = in_filters * expand_ratio
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self._expand_conv = Conv2d(in_filters, mid, 1, bias=False)
            self._bn0 = batch_norm(mid)
        self._depthwise_conv = StaticSameConv2d(
            mid, mid, kernel, stride, pad_h, pad_w, circular, groups=mid,
            circular_impl=circular_impl)
        self._bn1 = batch_norm(mid)
        # SE width comes from in_filters, not the expanded width
        reduced = max(1, int(in_filters * SE_RATIO))
        self._se_reduce = Conv2d(mid, reduced, 1)
        self._se_expand = Conv2d(reduced, mid, 1)
        self._project_conv = Conv2d(mid, out_filters, 1, bias=False)
        self._bn2 = batch_norm(out_filters)
        self.residual = stride == 1 and in_filters == out_filters
        self.drop_rate = drop_rate

    def uniforms(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        """The block's drop-connect uniforms for input x, or None where it
        drops nothing (eval mode, no residual, rate 0)."""
        if self.training and self.residual and self.drop_rate > 0:
            return drop_connect_uniforms(x, generator)
        return None

    def depthwise(self, x: torch.Tensor) -> torch.Tensor:
        """[expand 1x1 + BN + swish] -> the depthwise conv's output (dw_out)."""
        if self.has_expand:
            x = F.silu(self._bn0(self._expand_conv(x)))
        return self._depthwise_conv(x)

    def rest(self, dw: torch.Tensor, inputs: torch.Tensor,
             u: Optional[torch.Tensor]) -> torch.Tensor:
        """From dw_out to the block's output; u: drop-connect uniforms."""
        x = F.silu(self._bn1(dw))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self._se_expand(F.silu(self._se_reduce(s)))
        x = torch.sigmoid(s.float()).to(x.dtype) * x
        x = self._bn2(self._project_conv(x))
        if self.residual:
            if u is not None:
                x = apply_drop_connect(x, self.drop_rate, u)
            x = x + inputs.to(x.dtype)
        return x

    def forward(self, x: torch.Tensor, u: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rest(self.depthwise(x), x, u)

    def checkpointed(self, x: torch.Tensor, u: Optional[torch.Tensor],
                     policy: str = "none") -> torch.Tensor:
        """forward under checkpoint_block; 'save_dw' keeps dw_out."""
        if policy == "save_dw":
            return checkpoint_block(self.rest, checkpoint_block(self.depthwise, x), x, u)
        return checkpoint_block(self.forward, x, u)


class EfficientNetB0(nn.Module):
    """B0 feature extractor: NCHW image -> (head features, [16 block outputs]),
    computed in `compute_dtype`; with `remat`, blocks from `remat_skip` on
    run checkpointed under `remat_policy` in train mode with autograd on.
    `circular_impl` ('wrap' or 'edgefix') is how the stem and every
    depthwise conv wrap W when `circular`."""

    def __init__(self, circular: bool = False, head_features: int = 1280,
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_skip: int = 0, remat_policy: str = "none", circular_impl: str = "wrap"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat, self.remat_skip, self.remat_policy = remat, remat_skip, remat_policy
        pads = traced_same_pads()
        (ph, pw) = pads[0]
        self._conv_stem = StaticSameConv2d(3, 32, 3, 2, ph, pw, circular,
                                           circular_impl=circular_impl)
        self._bn0 = batch_norm(32)
        n = len(B0_BLOCK_SPECS)
        self._blocks = nn.ModuleList(
            MBConv(e, cin, cout, k, s, *pads[1 + i], circular,
                   drop_rate=DROP_CONNECT_RATE * i / n,      # model.py:262-264
                   circular_impl=circular_impl)
            for i, (e, cin, cout, k, s) in enumerate(B0_BLOCK_SPECS))
        self._conv_head = Conv2d(B0_BLOCK_SPECS[-1][2], head_features, 1, bias=False)
        self._bn1 = batch_norm(head_features)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """`generator` feeds drop-connect in train mode; eval mode ignores it."""
        x = x.to(self.compute_dtype)
        x = F.silu(self._bn0(self._conv_stem(x)))
        remat = self.remat and self.training and torch.is_grad_enabled()
        multiscale = []
        for i, block in enumerate(self._blocks):
            u = block.uniforms(x, generator)
            if remat and i >= self.remat_skip:
                x = block.checkpointed(x, u, self.remat_policy)
            else:
                x = block(x, u)
            multiscale.append(x)
        x = F.silu(self._bn1(self._conv_head(x)))
        return x, multiscale
