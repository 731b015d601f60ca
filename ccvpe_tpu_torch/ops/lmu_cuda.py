"""The fused LMU decoder stage on Hopper: the wrappers of csrc/lmu.cu, the
port of the Pallas kernels ccvpe_tpu/ops/lmu_pallas.py::_fused_stage_kernel
(:264, forward) and ::_fused_stage_bwd_kernel (:404, backward), and
`FusedStage`, the counterpart of the jax.custom_vjp fused_stage_diff
(:685-726): it saves only the inputs, and its backward is the backward
kernel, which recomputes h and g on chip.

`fused_stage` and `fused_stage_bwd` launch the kernels on CUDA tensors
(counting launches) and run the plain versions of ops/lmu.py on CPU
tensors. `fused_stage_split_plain` emulates B2's arithmetic (its convs
as 3xTF32 products where the kernel takes the tensor cores), and
`fwd_tile`, `tensor_core_conv`, `conv_tiles`, `conv_items` and
`fwd_mma_count` mirror its launch rules; `fused_stage_bwd_split_plain`
emulates B3's, and `bwd_tensor_core_conv`, `bwd_conv_tiles`,
`bwd_conv_items` and `bwd_mma_count` mirror the rules of its own convs.
`mma_probe` runs the kernels' 3xTF32 tensor-core primitive alone on one
matrix product, for checking it against float64 (its plain version is
ops/tf32.py::matmul_3xtf32_plain);
`mma_rate` measures the card's rate of its mma.sync. `bwd_phase_cycles`
runs the backward built with its per-phase timer (csrc/lmu.cu,
-DCCVPE_LMU_PHASE_TIMER, a library of its own) and returns the cycles
each block spent in each of BWD_PHASES; the main path never loads that
library. Shapes and layouts as
in ops/lmu.py: NHWC float32 activations, contiguous (the NHWC view of a
channels_last NCHW tensor is), torch weight layouts, which the wrappers
turn into the kernel's. Nothing touches nvcc or the card until a CUDA
tensor arrives.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain
from ccvpe_tpu_torch.ops.tf32 import matmul_3xtf32_plain


# The backward's tile loop, phase by phase, in the order the timer's
# sums come back (csrc/lmu.cu::BwdPhase).
BWD_PHASES = ("planes + wd", "deconv", "w1 load", "conv_a", "w2T load", "da",
              "dw2 db2 dw1 db1", "w1T load", "dh|dskip", "wdT load", "dx", "dwd dbd")
PHASE_TIMER = "CCVPE_LMU_PHASE_TIMER"
# Where the backward keeps its weight operands (csrc/lmu.cu::WeightMode).
WEIGHT_MODES = ("one buffer", "two buffers", "resident")


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccvpe_lmu_fwd.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.ccvpe_lmu_fwd.restype = i
    lib.ccvpe_lmu_bwd_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 5
    lib.ccvpe_lmu_bwd_plan.restype = i
    lib.ccvpe_lmu_bwd.argtypes = [p] * 14 + [i] * 12 + [p]
    lib.ccvpe_lmu_bwd.restype = i
    lib.ccvpe_mma_probe.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.ccvpe_mma_probe.restype = i
    lib.ccvpe_mma_rate.argtypes = [i] * 2 + [p] * 3
    lib.ccvpe_mma_rate.restype = i
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build csrc/lmu.cu for sm_90a at first use and bind its C entries."""
    from ccvpe_tpu_torch.csrc.build import build
    return _bind(build("lmu").path)


@functools.cache
def load_timed_library() -> ctypes.CDLL:
    """The same source built with the backward's per-phase timer."""
    from ccvpe_tpu_torch.csrc.build import build
    return _bind_timed(build("lmu", (PHASE_TIMER,)).path)


def _bind_timed(path) -> ctypes.CDLL:
    """_bind, and the timed build's entries."""
    lib = _bind(path)
    lib.ccvpe_lmu_bwd_phase_buffer.argtypes = [ctypes.c_void_p] * 2
    lib.ccvpe_lmu_bwd_phase_buffer.restype = ctypes.c_int
    lib.ccvpe_lmu_bwd_phases.restype = ctypes.c_int
    if lib.ccvpe_lmu_bwd_phases() != len(BWD_PHASES):
        raise RuntimeError(f"the timed library has {lib.ccvpe_lmu_bwd_phases()} phases, "
                           f"BWD_PHASES names {len(BWD_PHASES)}")
    return lib


def _dims(x, skip, wd, w1, w2):
    """(B, Hc, Wc, Cin, Cs, Cd, C1, Cout), checked against each other."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, Hc, Wc, Cin], got {tuple(x.shape)}")
    b, hc, wc, cin = x.shape
    cd = wd.shape[1]
    cs = 0 if skip is None else skip.shape[-1]
    c1, cout = w1.shape[0], w2.shape[0]
    expect = {"wd": (cin, cd, 2, 2), "w1": (c1, cd + cs, 3, 3), "w2": (cout, c1, 3, 3)}
    for name, t in (("wd", wd), ("w1", w1), ("w2", w2)):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expect[name]}")
    if skip is not None and tuple(skip.shape) != (b, 2 * hc, 2 * wc, cs):
        raise ValueError(f"skip has shape {tuple(skip.shape)}, expected {(b, 2 * hc, 2 * wc, cs)}")
    return b, hc, wc, cin, cs, cd, c1, cout


def _check(name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype} "
                        "(compute_dtype='bfloat16' is not ported)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC = channels_last NCHW)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def pad_co(c: int) -> int:
    """Columns of a weight operand with c output channels in the kernel's
    layout (csrc/lmu.cu::pad_co): 4 up to 4 channels, else a multiple of 8."""
    return 4 if c <= 4 else (c + 7) // 8 * 8


# The forward's fine tiles, largest first, and the shared memory a block
# may have on an H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin).
FWD_TILES = (16, 8, 4)
MAX_BLOCK_SMEM = 232448


def plane_stride(side: int) -> int:
    """Floats between two channel planes of side^2 pixels (csrc/lmu.cu)."""
    return (side * side + 3) // 8 * 8 + 4


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def fwd_smem_bytes(cin: int, cs: int, cd: int, c1: int, cout: int, t: int) -> int:
    """Dynamic shared memory of B2 at fine tile t (csrc/lmu.cu::fwd_layout):
    h|skip planes on (t+4)^2, later w2; the coarse x planes, later g on
    (t+2)^2; wd, later w1."""
    c, hs, gs = cd + cs, t + 4, t + 2
    a = max(c * plane_stride(hs), 9 * c1 * pad_co(cout))
    b = max(c1 * plane_stride(gs), cin * plane_stride(hs // 2))
    w = max(4 * cin * pad_co(cd), 9 * c * pad_co(c1))
    return 4 * (_round4(a) + _round4(b) + _round4(w))


def fwd_tile(cin: int, cs: int, cd: int, c1: int, cout: int,
             limit: int = MAX_BLOCK_SMEM) -> int:
    """The fine tile B2 picks (ccvpe_lmu_fwd with t = 0): the largest of
    FWD_TILES whose shared memory fits in `limit` bytes."""
    for t in FWD_TILES:
        if fwd_smem_bytes(cin, cs, cd, c1, cout, t) <= limit:
            return t
    raise ValueError("the stage's planes and weights fit no tile")


def tensor_core_conv(cout: int) -> bool:
    """The route of a forward conv with `cout` output channels
    (csrc/lmu.cu::fwd_conv): the tensor cores where pad_co(cout) is a
    multiple of 8, i.e. cout >= 5; else the CUDA cores' FMAs."""
    return pad_co(cout) % 8 == 0


def conv_tiles(cout: int) -> int:
    """n-tiles of 8 channels in one warp item of a tensor-core conv (and of
    a weight gradient), csrc/lmu.cu::wgrad_tiles: the largest of 5, 4, 2, 1
    that divides ceil(cout / 8)."""
    tiles = -(-cout // 8)
    return next(n for n in (5, 4, 2, 1) if tiles % n == 0)


# m-tiles of 16 pixels in one warp item of a tensor-core conv, in the
# forward and in the backward's recompute (csrc/lmu.cu::kFwdMTiles,
# kBwdMTiles)
FWD_MTILES, BWD_MTILES = 2, 1


def conv_items(out_side: int, cout: int, mtiles: int = FWD_MTILES) -> int:
    """Warp items of a tensor-core conv over an out_side^2 pixel box:
    groups of `mtiles` m-tiles of 16 pixels times groups of
    conv_tiles(cout) n-tiles."""
    return -(-out_side * out_side // (16 * mtiles)) * -(-cout // (8 * conv_tiles(cout)))


def fwd_mma_count(b: int, hc: int, wc: int, cin: int, cs: int, cd: int, c1: int, cout: int,
                  t: int) -> int:
    """The m16n8k8 TF32 mma.sync instructions B2 issues for one call at
    fine tile t (warp-level, three per 16 x 8 x 8 product): per tile the
    deconv's four phases on the (t+4)/2 coarse box, conv_a on the (t+2)^2
    box and conv_b on the t^2 box, each that takes the tensor cores, as
    items x m-tiles x taps x k-steps of 8 channels x n-tiles x 3."""
    def conv(out_side, c_in, c_out, taps):
        if not tensor_core_conv(c_out):
            return 0
        return (conv_items(out_side, c_out) * FWD_MTILES * taps * -(-c_in // 8)
                * conv_tiles(c_out) * 3)

    per_tile = (4 * conv((t + 4) // 2, cin, cd, 1) + conv(t + 2, cd + cs, c1, 9)
                + conv(t, c1, cout, 9))
    return b * -(-2 * hc // t) * -(-2 * wc // t) * per_tile


def bwd_tensor_core_conv(n: int, k: int) -> bool:
    """The route of one of B3's own convs (da, dh|dskip, dx) with n output
    channels and k input channels a tap (csrc/lmu.cu::bwd_tensor_core): the
    tensor cores where n spans at least 3 n-tiles (pad_co(n) >= 24) and k
    pads to a multiple of 8 (k >= 5); else the CUDA cores' FMAs (the heads'
    da, k = Cout 1 or 2, and dh|dskip, n = 16)."""
    return pad_co(n) >= 24 and pad_co(k) % 8 == 0


BWD_CONV_ITEMS = 9   # csrc/lmu.cu::kBwdConvItems


def _bwd_mtiles(out_side: int) -> int:
    return -(-out_side * out_side // (16 * BWD_MTILES))


def bwd_conv_tiles(n: int, out_side: int) -> int:
    """n-tiles of 8 channels in one warp item of a backward conv over an
    out_side^2 box (csrc/lmu.cu::bwd_conv_tiles): 4, else 2, the wider that
    still gives the conv at least BWD_CONV_ITEMS items (the last group
    ragged where it does not divide the tile count), else 1."""
    tiles, m = -(-n // 8), _bwd_mtiles(out_side)
    for nt in (4, 2):
        if tiles >= nt and m * -(-tiles // nt) >= BWD_CONV_ITEMS:
            return nt
    return 1


def bwd_conv_items(out_side: int, n: int) -> int:
    """Warp items of a backward tensor-core conv over an out_side^2 box:
    BWD_MTILES m-tiles of 16 pixels times groups of bwd_conv_tiles n-tiles,
    the last group ragged."""
    return _bwd_mtiles(out_side) * -(-(-(-n // 8)) // bwd_conv_tiles(n, out_side))


def bwd_convs(cin: int, cs: int, cd: int, c1: int, cout: int, t: int) -> dict:
    """B3's own convs at fine tile t: name -> (output box side, input
    channels a tap, output channels, taps)."""
    return {"da": (t + 2, cout, c1, 9), "dh|dskip": (t, c1, cd + cs, 9),
            "dx": (t // 2, cd, cin, 4)}


def bwd_mma_per_tile(cin: int, cs: int, cd: int, c1: int, cout: int, t: int) -> dict:
    """The m16n8k8 TF32 mma.sync instructions B3 issues for one fine tile
    t, by part (three per 16 x 8 x 8 product): the recompute of h (the
    deconv's four phases on the (t+4)/2 coarse box) and g (conv_a on the
    (t+2)^2 box) by the forward's route with BWD_MTILES m-tiles an item;
    the weight gradients dw2, dw1 (9 taps over the t^2 pixels) and dwd (4
    phases over the (t/2)^2 coarse pixels), items of 16 input channels by
    conv_tiles n-tiles; and da, dh|dskip and dx where bwd_tensor_core_conv
    takes the tensor cores, as items x taps x k-steps x n-tiles x 3."""
    c = cd + cs

    def fwd(out_side, k, n, taps):
        if not tensor_core_conv(n):
            return 0
        return (conv_items(out_side, n, BWD_MTILES) * BWD_MTILES * taps * -(-k // 8)
                * conv_tiles(n) * 3)

    def wgrad(taps, pixels, m, n):
        nt = conv_tiles(n)
        return taps * -(-m // 16) * -(-n // (8 * nt)) * -(-pixels // 8) * nt * 3

    out = {"deconv": 4 * fwd((t + 4) // 2, cin, cd, 1), "conv_a": fwd(t + 2, c, c1, 9),
           "dw2": wgrad(9, t * t, c1, cout), "dw1": wgrad(9, t * t, c, c1),
           "dwd": wgrad(4, (t // 2) ** 2, cin, cd)}
    for name, (side, k, n, taps) in bwd_convs(cin, cs, cd, c1, cout, t).items():
        out[name] = (bwd_conv_items(side, n) * BWD_MTILES * taps * -(-k // 8)
                     * bwd_conv_tiles(n, side) * 3 if bwd_tensor_core_conv(n, k) else 0)
    return out


def bwd_mma_count(b: int, hc: int, wc: int, cin: int, cs: int, cd: int, c1: int, cout: int,
                  t: int) -> int:
    """The mma.sync instructions B3 issues for one call at fine tile t: the
    tiles times the sum of bwd_mma_per_tile."""
    return (b * -(-2 * hc // t) * -(-2 * wc // t)
            * sum(bwd_mma_per_tile(cin, cs, cd, c1, cout, t).values()))


def _padded(t: torch.Tensor) -> torch.Tensor:
    """[..., n] -> contiguous [..., pad_co(n)], zeros in the added columns."""
    return F.pad(t, (0, pad_co(t.shape[-1]) - t.shape[-1])).contiguous()


def kernel_weights(wd: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """torch layouts -> the kernel's operands (phase di*2+dj, tap ky*3+kx):
    wd [4][Cin][Cd], w1 [9][C][C1], w2 [9][C1][Cout] and, for the backward,
    the flipped-transposed w2T [9][Cout][C1] and w1T [9][C1][C] of the
    transposed convs and wdT [4][Cd][Cin] of dx (the TPU kernel's _flipT),
    each with its last dimension padded with zeros to pad_co columns, so
    that the kernels copy an operand as one flat run of 16-byte transfers."""
    wd, w1, w2 = wd.detach(), w1.detach(), w2.detach()
    cin, cd = wd.shape[:2]
    c1, c = w1.shape[:2]
    cout = w2.shape[0]
    return tuple(_padded(t) for t in (
        wd.permute(2, 3, 0, 1).reshape(4, cin, cd),
        w1.permute(2, 3, 1, 0).reshape(9, c, c1),
        w2.permute(2, 3, 1, 0).reshape(9, c1, cout),
        w2.flip(2, 3).permute(2, 3, 0, 1).reshape(9, cout, c1),
        w1.flip(2, 3).permute(2, 3, 0, 1).reshape(9, c1, c),
        wd.permute(2, 3, 1, 0).reshape(4, cd, cin)))


def _product(a: torch.Tensor, b: torch.Tensor, tensor_cores: bool) -> torch.Tensor:
    """a [M, K] @ b [K, N]: as 3xTF32 products where the kernel takes the
    tensor cores, else in float32."""
    return matmul_3xtf32_plain(a, b) if tensor_cores else a @ b


def _im2col3x3(inp: torch.Tensor) -> torch.Tensor:
    """[B*H*W, 9*C] columns of NHWC `inp` with zero padding, K in the
    kernel's order (tap ky*3+kx, then channel)."""
    b, h, w, c = inp.shape
    pad = F.pad(inp, (0, 0, 1, 1, 1, 1))
    return torch.cat([pad[:, ky:ky + h, kx:kx + w, :] for ky in range(3) for kx in range(3)],
                     dim=-1).reshape(-1, 9 * c)


def _conv3x3_split(inp: torch.Tensor, w: torch.Tensor, tensor_cores: bool) -> torch.Tensor:
    """conv3x3 of NHWC `inp` with zero padding and torch weight w
    (Cout, C, 3, 3), as im2col and one product."""
    b, h, wd_, c = inp.shape
    wmat = w.permute(2, 3, 1, 0).reshape(9 * c, w.shape[0])
    return _product(_im2col3x3(inp), wmat, tensor_cores).reshape(b, h, wd_, w.shape[0])


def _deconv_split(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """h = deconv2x2(x) + bd, NHWC, as one product with the four phases side
    by side."""
    b, hc, wc, cin = x.shape
    cd = wd.shape[1]
    wmat = wd.permute(0, 2, 3, 1).reshape(cin, 4 * cd)          # columns (di, dj, co)
    h = _product(x.reshape(-1, cin), wmat, tensor_core_conv(cd)).reshape(b, hc, wc, 2, 2, cd)
    return h.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * hc, 2 * wc, cd) + bd


def fused_stage_split_plain(x: torch.Tensor, skip: Optional[torch.Tensor], wd: torch.Tensor,
                            bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """What B2 computes, in plain torch: each conv as one product (the
    deconv's four phases side by side, the 3x3 convs as im2col with zero
    borders) through
    matmul_3xtf32_plain where tensor_core_conv takes the tensor cores, else
    in float32; biases added after each sum, the ReLU after conv_a's. Sums
    inside a product run in the matmul's order, not the tensor cores'.
    Same contract as fused_stage_plain."""
    x, wd, w1, w2 = (t.detach().float() for t in (x, wd, w1, w2))
    h = _deconv_split(x, wd, bd.detach())
    if skip is not None:
        h = torch.cat([h, skip.detach().float()], dim=-1)
    g = torch.relu(_conv3x3_split(h, w1, tensor_core_conv(w1.shape[0])) + b1.detach())
    return _conv3x3_split(g, w2, tensor_core_conv(w2.shape[0])) + b2.detach()


def fused_stage_bwd_split_plain(x: torch.Tensor, skip: Optional[torch.Tensor], dy: torch.Tensor,
                                wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor,
                                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
                                ) -> Tuple[Optional[torch.Tensor], ...]:
    """What B3 computes, in plain torch: h and g recomputed as
    fused_stage_split_plain computes them; da = relu'(a) * conv3x3(dy,
    flipT(w2)), [dh | dskip] = conv3x3(da, flipT(w1)) and dx (dh's four
    deconv phases side by side, against wdT) each as one product with K in
    the kernel's order (tap, then channel), through matmul_3xtf32_plain
    where bwd_tensor_core_conv takes the tensor cores, else in float32; the
    weight gradients as products over the pixels in 3xTF32, as the kernel
    always runs them, the bias gradients as float32 sums. Sums inside a
    product run in the matmul's order, not the tensor cores'. Same contract
    as fused_stage_bwd_plain."""
    b, hc, wc, cin = x.shape
    cd, c1, cout = wd.shape[1], w1.shape[0], w2.shape[0]
    x, wd, w1, w2, dy = (t.detach().float() for t in (x, wd, w1, w2, dy))
    h = _deconv_split(x, wd, bd.detach())
    if skip is not None:
        h = torch.cat([h, skip.detach().float()], dim=-1)
    c = h.shape[-1]
    a = _conv3x3_split(h, w1, tensor_core_conv(c1)) + b1.detach()
    g = torch.relu(a)
    # the transposed convs: torch weights (C_out, C_in, 3, 3) of flipT(w)
    da = _conv3x3_split(dy, w2.flip(2, 3).transpose(0, 1), bwd_tensor_core_conv(c1, cout))
    da = torch.where(a > 0, da, torch.zeros_like(da))
    dhs = _conv3x3_split(da, w1.flip(2, 3).transpose(0, 1), bwd_tensor_core_conv(c, c1))
    dh, dskip = dhs[..., :cd], (dhs[..., cd:] if skip is not None else None)
    phases = [dh[:, di::2, dj::2, :] for di in range(2) for dj in range(2)]
    cols = torch.cat(phases, dim=-1).reshape(-1, 4 * cd)          # K = (phase, channel)
    wdt = wd.permute(2, 3, 1, 0).reshape(4 * cd, cin)
    dx = _product(cols, wdt, bwd_tensor_core_conv(cin, cd)).reshape(b, hc, wc, cin)

    def wgrad(inp, out):                                          # inp^T out over pixels
        return matmul_3xtf32_plain(inp.t().contiguous(), out)

    dw2 = wgrad(_im2col3x3(g), dy.reshape(-1, cout)).reshape(3, 3, c1, cout).permute(3, 2, 0, 1)
    dw1 = wgrad(_im2col3x3(h), da.reshape(-1, c1)).reshape(3, 3, c, c1).permute(3, 2, 0, 1)
    xm = x.reshape(-1, cin)
    dwd = torch.stack([wgrad(xm, ph.reshape(-1, cd)) for ph in phases]).reshape(2, 2, cin, cd)
    return (dx, dskip, dwd.permute(2, 3, 0, 1), dh.sum((0, 1, 2)), dw1, da.sum((0, 1, 2)), dw2,
            dy.sum((0, 1, 2)))


def _check_operand(name: str, t: torch.Tensor, device) -> None:
    _check(name, t, device)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (cp.async copies)")


def fused_stage(x: torch.Tensor, skip: Optional[torch.Tensor], wd: torch.Tensor,
                bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, tile: int = 0) -> torch.Tensor:
    """Kernel B2 on a CUDA tensor, fused_stage_plain on a CPU one: y NHWC
    [B, 2Hc, 2Wc, Cout] float32. Counts launches in fused_stage.launches.
    `tile` 0 lets the kernel pick its fine tile T (fwd_tile); 16, 8 or 4
    forces it, for the checks that y does not depend on T."""
    if tile not in (0,) + FWD_TILES:
        raise ValueError(f"tile must be 0 or one of {FWD_TILES}, got {tile}")
    if not x.is_cuda:
        return fused_stage_plain(x, skip, wd, bd, w1, b1, w2, b2)
    b, hc, wc, cin, cs, cd, c1, cout = _dims(x, skip, wd, w1, w2)
    dev = x.device
    for name, t in (("x", x), ("skip", skip), ("bd", bd), ("b1", b1), ("b2", b2)):
        if t is not None:
            _check(name, t, dev)
    wdk, w1k, w2k = kernel_weights(wd, w1, w2)[:3]
    for name, t in (("wd", wdk), ("w1", w1k), ("w2", w2k)):
        _check_operand(name, t, dev)
    lib = load_library()
    y = torch.empty((b, 2 * hc, 2 * wc, cout), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccvpe_lmu_fwd(x.data_ptr(), _ptr(skip), wdk.data_ptr(), bd.data_ptr(),
                               w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(), b2.data_ptr(),
                               y.data_ptr(), b, hc, wc, cin, cs, cd, c1, cout, tile, stream)
    if rc != 0:
        raise RuntimeError(f"ccvpe_lmu_fwd launch failed: CUDA error {rc}")
    fused_stage.launches += 1
    return y


fused_stage.launches = 0


def fused_stage_bwd(x: torch.Tensor, skip: Optional[torch.Tensor], dy: torch.Tensor,
                    wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """Kernel B3 on a CUDA tensor, fused_stage_bwd_plain on a CPU one:
    (dx, dskip or None, dwd, dbd, dw1, db1, dw2, db2), weights' grads in
    torch layouts. Counts launches in fused_stage_bwd.launches."""
    if not x.is_cuda:
        return fused_stage_bwd_plain(x, skip, dy, wd, bd, w1, b1, w2, b2)
    grads, _ = _launch_bwd(load_library(), x, skip, dy, wd, bd, w1, b1, w2, b2)
    fused_stage_bwd.launches += 1
    return grads


fused_stage_bwd.launches = 0


def bwd_phase_cycles(x: torch.Tensor, skip: Optional[torch.Tensor], dy: torch.Tensor,
                     wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor):
    """B3 built with its per-phase timer, on CUDA tensors only (the timer
    is a clock on the card): (the grads as fused_stage_bwd returns them,
    int64 [blocks, len(BWD_PHASES)] clock64 cycles each block spent in each
    phase, summed over its tiles). Not counted in fused_stage_bwd.launches:
    the main path runs the untimed library."""
    if not x.is_cuda:
        raise ValueError("the phase timer runs on the card: pass CUDA tensors")
    return _launch_bwd(load_timed_library(), x, skip, dy, wd, bd, w1, b1, w2, b2, timed=True)


def _launch_bwd(lib, x, skip, dy, wd, bd, w1, b1, w2, b2, timed=False):
    b, hc, wc, cin, cs, cd, c1, cout = _dims(x, skip, wd, w1, w2)
    if tuple(dy.shape) != (b, 2 * hc, 2 * wc, cout):
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected {(b, 2 * hc, 2 * wc, cout)}")
    dev = x.device
    for name, t in (("x", x), ("skip", skip), ("dy", dy), ("bd", bd), ("b1", b1)):
        if t is not None:
            _check(name, t, dev)
    wdk, w1k, _, w2t, w1t, wdt = kernel_weights(wd, w1, w2)
    for name, t in (("wd", wdk), ("w1", w1k), ("w2t", w2t), ("w1t", w1t), ("wdt", wdt)):
        _check_operand(name, t, dev)
    with torch.cuda.device(dev):
        t_, mode, ahead, nblk, psize = _plan(lib, b, hc, wc, cin, cs, cd, c1, cout)
        dx = torch.empty_like(x)
        dskip = None if skip is None else torch.empty_like(skip)
        part = torch.zeros((nblk, psize), device=dev, dtype=torch.float32)
        sums = torch.empty(psize, device=dev, dtype=torch.float32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        cycles = None
        if timed:
            cycles = torch.zeros((nblk, len(BWD_PHASES)), device=dev, dtype=torch.int64)
            rc = lib.ccvpe_lmu_bwd_phase_buffer(cycles.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"ccvpe_lmu_bwd_phase_buffer failed: CUDA error {rc}")
        rc = lib.ccvpe_lmu_bwd(x.data_ptr(), _ptr(skip), dy.data_ptr(), wdk.data_ptr(),
                               bd.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                               w1t.data_ptr(), wdt.data_ptr(), dx.data_ptr(), _ptr(dskip),
                               part.data_ptr(), sums.data_ptr(), b, hc, wc, cin, cs, cd, c1,
                               cout, t_, mode, ahead, nblk, stream)
    if rc != 0:
        raise RuntimeError(f"ccvpe_lmu_bwd launch failed: CUDA error {rc}")
    c = cd + cs
    dwd, dbd, dw1, db1, dw2, db2 = torch.split(
        sums, [4 * cin * cd, cd, 9 * c * c1, c1, 9 * c1 * cout, cout])
    return (dx, dskip,
            dwd.reshape(2, 2, cin, cd).permute(2, 3, 0, 1),
            dbd,
            dw1.reshape(3, 3, c, c1).permute(3, 2, 0, 1),
            db1,
            dw2.reshape(3, 3, c1, cout).permute(3, 2, 0, 1),
            db2), cycles


def _plan(lib, b, hc, wc, cin, cs, cd, c1, cout):
    """ccvpe_lmu_bwd_plan on the current device: (T, weight mode, planes
    copied a tile ahead (0 or 1), blocks, floats of a block's partial slice)."""
    out = [ctypes.c_int(0) for _ in range(5)]
    rc = lib.ccvpe_lmu_bwd_plan(b, hc, wc, cin, cs, cd, c1, cout, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"ccvpe_lmu_bwd_plan failed: CUDA error {rc}")
    return tuple(v.value for v in out)


def bwd_plan(x: torch.Tensor, skip: Optional[torch.Tensor], wd: torch.Tensor,
             w1: torch.Tensor, w2: torch.Tensor) -> dict:
    """How B3 runs these shapes on x's card: its fine tile T, where it keeps
    the weights (one of WEIGHT_MODES), whether each tile's x and dy planes
    are copied while the one before runs, its blocks and tiles."""
    b, hc, wc, cin, cs, cd, c1, cout = _dims(x, skip, wd, w1, w2)
    with torch.cuda.device(x.device):
        t, mode, ahead, nblk, _ = _plan(load_library(), b, hc, wc, cin, cs, cd, c1, cout)
    return dict(t=t, weights=WEIGHT_MODES[mode], planes_ahead=bool(ahead), blocks=nblk,
                tiles=b * -(-2 * hc // t) * -(-2 * wc // t))


class FusedStage(torch.autograd.Function):
    """Differentiable fused stage: B2 forward, B3 backward; only the inputs
    are saved, so the 2x-resolution intermediates never persist."""

    @staticmethod
    def forward(ctx, x, skip, wd, bd, w1, b1, w2, b2):
        ctx.save_for_backward(x, skip, wd, bd, w1, b1, w2, b2)
        return fused_stage(x, skip, wd, bd, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, skip, wd, bd, w1, b1, w2, b2 = ctx.saved_tensors
        return fused_stage_bwd(x, skip, dy.contiguous(), wd, bd, w1, b1, w2, b2)


def mma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] through the kernel's 3xTF32 mma.sync primitive
    (one block, operands in shared memory) on CUDA tensors, through
    matmul_3xtf32_plain on CPU ones. Counts launches in mma_probe.launches."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected [M, K] @ [K, N], got {tuple(a.shape)} @ {tuple(b.shape)}")
    if not a.is_cuda:
        return matmul_3xtf32_plain(a, b)
    for name, t in (("a", a), ("b", b)):
        _check(name, t, a.device)
    (m, k), n = a.shape, b.shape[1]
    lib = load_library()
    c = torch.empty((m, n), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.ccvpe_mma_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"ccvpe_mma_probe launch failed: CUDA error {rc}")
    mma_probe.launches += 1
    return c


mma_probe.launches = 0


def mma_rate(iters: int = 20000) -> dict:
    """The card's issue rate of the m16n8k8 TF32 mma.sync the kernels'
    products are made of (csrc/lmu.cu::mma_rate_kernel: one block of 16
    warps per SM, each warp 8 independent products per round, no loads):
    ms, clock64 cycles per product per SM sub-partition (4 per SM), and
    TF32 TFLOP/s (2048 flops a product). On the card only."""
    if not torch.cuda.is_available():
        raise ValueError("the rate is the card's: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = load_library()
    out = torch.empty(sms * 512, device=dev)
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n in (100, iters):                          # the first launch warms up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.ccvpe_mma_rate(sms, n, out.data_ptr(), cycles.data_ptr(), stream)
        end.record()
        if rc != 0:
            raise RuntimeError(f"ccvpe_mma_rate launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    per_sm = 16 * 8 * iters
    return dict(ms=ms, cycles_per_mma_per_smsp=float(cycles.double().mean()) / (per_sm / 4),
                tflops=per_sm * sms * 2048 / ms / 1e9)
