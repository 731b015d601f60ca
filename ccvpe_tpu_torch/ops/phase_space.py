"""Phase-space (space-to-depth) fine decoder stages (the port of
ccvpe_tpu/ops/phase_space.py, ModelConfig.phase_space_min_res).

A fine map [B, C, 2H, 2W] is kept in its 2x2 space-to-depth packing
[B, 4C, H, W], channel (di*2 + dj)*C + c = fine[2I+di, 2J+dj, c]:

  * deconv2x2 (kernel 2, stride 2) has no tap overlap, so packed it is one
    matmul x @ W[Cin, 4*Cd];
  * a fine 3x3 pad-1 conv becomes, per output phase (pi, pj), a 2x2 coarse
    conv over all four input phases: fine row 2I+pi+dy lies in coarse row
    I + ((pi+dy) >> 1) of input phase (pi+dy) & 1, so each of the 9 fine
    taps takes one (row, col, phase) slot of a [2, 2, 4Cin, Cout] kernel;
  * only the stage's result is unpacked (`depth_to_space`), or handed
    packed to the final head (nn/decoder.py::HeadConv, packed=True).

The same taps and weights as the fine-layout ops: the packed kernels are
built from the stored weights at each call, so the parameters (and the
state dict) are those of the fine stage. Tensors are NCHW; weights in
torch's layouts: the deconv's (Cin, Cd, 2, 2), a conv's (Cout, Cin, 3, 3).
Convs compute in their input's dtype (bf16 under compute_dtype='bfloat16'),
with the float32 bias added after, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def depth_to_space(y: torch.Tensor, cout: int) -> torch.Tensor:
    """[B, 2*2*Cout, H, W] phase layout -> [B, Cout, 2H, 2W]; channel index
    (di*2 + dj)*Cout + c."""
    b, _, h, w = y.shape
    return y.reshape(b, 2, 2, cout, h, w).permute(0, 3, 4, 1, 5, 2).reshape(b, cout, 2 * h, 2 * w)


def space_to_depth(y: torch.Tensor) -> torch.Tensor:
    """[B, C, 2H, 2W] -> [B, 2*2*C, H, W] phase layout (the inverse of
    `depth_to_space`)."""
    b, c, h2, w2 = y.shape
    return (y.reshape(b, c, h2 // 2, 2, w2 // 2, 2).permute(0, 3, 5, 1, 2, 4)
            .reshape(b, 4 * c, h2 // 2, w2 // 2))


def deconv2x2_packed(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=2, s=2) to the packed fine map, float32: x [B, Cin,
    H, W], kernel (Cin, Cd, 2, 2) -> [B, 4*Cd, H, W] with channel (di*2 +
    dj)*Cd + o = fine[2I+di, 2J+dj, o]. One matmul of the operands in x's
    dtype with float32 sums (the products of two bf16 values are exact in
    float32), plus the bias."""
    cin, cd = kernel.shape[:2]
    w = kernel.permute(0, 2, 3, 1).reshape(cin, 4 * cd).to(x.dtype).float()
    y = torch.matmul(x.float().permute(0, 2, 3, 1), w) + bias.repeat(4)
    return y.permute(0, 3, 1, 2)


def phase_conv_kernel(w: torch.Tensor, pi: int, pj: int, cd: int, cs: int) -> torch.Tensor:
    """(Cout, 4*cd + 4*cs, 2, 2) packed kernel of output phase (pi, pj).

    w: (Cout, cd + cs, 3, 3), a fine 3x3 conv whose input channels are
    [deconv block | skip block]; the packed input is [4*cd phase-major |
    4*cs phase-major] (the deconv's output beside space_to_depth of the
    skip, so the interleave happens here, on the weights). Tap (dy, dx)
    reads input phase q = 2*((pi+dy)&1) + ((pj+dx)&1) at coarse offset
    (si, sj) = ((pi+dy)>>1, (pj+dx)>>1); with the padding ((1-pi, pi),
    (1-pj, pj)) its slot is (si+1-pi, sj+1-pj)."""
    cout = w.shape[0]
    kp = w.new_zeros(cout, 4 * (cd + cs), 2, 2)
    for dy in (-1, 0, 1):
        qi, si = (pi + dy) & 1, (pi + dy) >> 1
        a = si + 1 - pi
        for dx in (-1, 0, 1):
            qj, sj = (pj + dx) & 1, (pj + dx) >> 1
            b = sj + 1 - pj
            q = 2 * qi + qj
            tap = w[:, :, 1 + dy, 1 + dx]                 # (Cout, cd + cs)
            kp[:, q * cd:(q + 1) * cd, a, b] = tap[:, :cd]
            if cs:
                kp[:, 4 * cd + q * cs:4 * cd + (q + 1) * cs, a, b] = tap[:, cd:]
    return kp


def conv3x3_packed(z: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   cd: Optional[int] = None, cs: int = 0, impl: str = "onebig") -> torch.Tensor:
    """A fine 3x3 pad-1 conv on a packed map, float32 out.

    z: [B, 4*cd + 4*cs, H, W] packed (`phase_conv_kernel` gives the channel
    layout; cs = 0 for a uniformly packed input); w (Cout, cd + cs, 3, 3),
    bias [Cout], the stored fine conv's. Returns [B, 4*Cout, H, W] packed.

    impl 'onebig': one conv with all four phases' kernels as output blocks
    on the 1-padded input, each phase's window at its own offset (a
    slice); 'phase4': four convs with each phase's asymmetric padding. The
    same 9-tap sum per output either way. The conv runs in z's dtype."""
    if cd is None:
        cd = w.shape[1]
    cout = w.shape[0]
    h, wd = z.shape[2:]
    if impl == "phase4":
        y = torch.cat([F.conv2d(F.pad(z, (1 - pj, pj, 1 - pi, pi)),
                                phase_conv_kernel(w, pi, pj, cd, cs).to(z.dtype))
                       for pi in (0, 1) for pj in (0, 1)], dim=1)
    elif impl == "onebig":
        k = torch.cat([phase_conv_kernel(w, pi, pj, cd, cs) for pi in (0, 1) for pj in (0, 1)])
        full = F.conv2d(z, k.to(z.dtype), padding=1)          # [B, 4*Cout, H+1, W+1]
        y = torch.cat([full[:, (2 * pi + pj) * cout:(2 * pi + pj + 1) * cout,
                            pi:pi + h, pj:pj + wd]
                       for pi in (0, 1) for pj in (0, 1)], dim=1)
    else:
        raise ValueError(f"impl must be 'onebig' or 'phase4', got {impl!r}")
    return y.float() + bias.float().repeat(4)[:, None, None]


def phase_stage(x: torch.Tensor, skip: Optional[torch.Tensor],
                deconv_kernel: torch.Tensor, deconv_bias: torch.Tensor,
                wa: Optional[torch.Tensor], ba: Optional[torch.Tensor],
                wb: Optional[torch.Tensor], bb: Optional[torch.Tensor],
                dtype: torch.dtype = torch.bfloat16, impl: str = "onebig",
                unpack: bool = True) -> torch.Tensor:
    """One LMU stage in phase space: deconv2x2 -> [skip concat] -> conv3x3
    -> ReLU -> conv3x3, each result in `dtype`. wa/ba/wb/bb None: the
    deconv-only final stage (its head runs outside; pass unpack=False and
    feed the packed result to a packed head). Returns [B, C, 2H, 2W] if
    unpack, else the packed [B, 4C, H, W]."""
    d = deconv2x2_packed(x.to(dtype), deconv_kernel, deconv_bias).to(dtype)
    cd, cs = deconv_kernel.shape[1], 0
    if skip is not None:
        cs = skip.shape[1]
        d = torch.cat([d, space_to_depth(skip.to(dtype))], dim=1)
    if wa is not None:
        g = F.relu(conv3x3_packed(d, wa, ba, cd, cs, impl).to(dtype))
        d = conv3x3_packed(g, wb, bb, impl=impl).to(dtype)
        cd, cs = wb.shape[0], 0
    elif cs:
        raise ValueError("deconv-only stage cannot carry a skip")
    return depth_to_space(d, cd) if unpack else d
