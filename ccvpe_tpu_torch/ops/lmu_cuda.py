"""The fused LMU decoder stage on Hopper: the wrappers of csrc/lmu.cu
(float32 activations) and csrc/lmu_bf16.cu (bf16 activations), the port of
the Pallas kernels ccvpe_tpu/ops/lmu_pallas.py::_fused_stage_kernel (:264,
forward) and ::_fused_stage_bwd_kernel (:404, backward).

`fused_stage` and `fused_stage_bwd` launch the kernels on CUDA tensors
(counting launches, bf16 ones apart in `bf16_launches`; core/profiling.py::
counters() reports them as `launches.lmu_fwd[.bf16]` and
`launches.lmu_bwd[.bf16]`) and run the plain
versions of ops/lmu.py on CPU tensors. `fused_stage_split_plain` emulates
the float32 B2's arithmetic (its convs as 3xTF32 products where the kernel
takes the tensor cores), and `fwd_tile`, `tensor_core_conv`, `conv_tiles`,
`conv_items` and `fwd_mma_count` mirror its launch rules;
`fused_stage_bwd_split_plain` emulates B3's, and `bwd_tensor_core_conv`,
`bwd_conv_tiles`, `bwd_conv_items` and `bwd_mma_count` mirror the rules of
its own convs. `fused_stage_bf16_split_plain` and
`fused_stage_bwd_bf16_split_plain` emulate the bf16 kernels' (every conv on
bf16 tensor-core products, K in their order), and `pix_stride`, `n_group`,
`bf16_fwd_tile`, `bf16_bwd_tile` and the `*_smem_bytes` functions mirror
their layouts and plans. `mma_probe` runs one of the kernels' tensor-core
primitives alone on one matrix product (its plain versions:
ops/tf32.py::matmul_3xtf32_plain, and a float32 product of bf16 values);
`mma_rate` measures the card's rate of their mma.sync. `bwd_phase_cycles`
runs a backward built with its per-phase timer (-DCCVPE_LMU_PHASE_TIMER, a
library of its own) and returns the cycles each block spent in each of
BWD_PHASES; the main path never loads that library. Shapes and layouts as
in ops/lmu.py: NHWC activations, float32 or bf16 (the TPU kernels' bf16
policy, ops/lmu.py), contiguous (the NHWC view of a channels_last NCHW
tensor is), torch weight layouts, which the wrappers turn into the
kernels'. Nothing touches nvcc or the card until a CUDA tensor arrives.

B2 is the registered op `ccvpe_tpu_torch::lmu_fwd` (importing this module
registers it): its CUDA implementation launches the kernel, its
implementation for other devices is `fused_stage_plain`, and its fake one
gives y's shape, so `torch.export` records it as one node and a CUDA graph
captures its launch. Its gradient is registered with it
(`torch.library.register_autograd`, the counterpart of the jax.custom_vjp
fused_stage_diff, lmu_pallas.py:685-726): the forward saves only the
inputs, and the backward is `fused_stage_bwd`, kernel B3 on the card, which
recomputes h and g on chip. B3 is a plain call from there: no exported
program holds a backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ccvpe_tpu_torch.core.profiling import register_launches
from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain, round_bf16
from ccvpe_tpu_torch.ops.tf32 import matmul_3xtf32_plain


# The backward's tile loop, phase by phase, in the order the timer's
# sums come back (csrc/lmu.cu::BwdPhase).
BWD_PHASES = ("planes + wd", "deconv", "w1 load", "conv_a", "w2T load", "da",
              "dw2 db2 dw1 db1", "w1T load", "dh|dskip", "wdT load", "dx", "dwd dbd")
PHASE_TIMER = "CCVPE_LMU_PHASE_TIMER"
BF16_SOURCE = "lmu_bf16"     # csrc/lmu_bf16.cu, the kernels on bf16 activations
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


def _bind_bf16(path) -> ctypes.CDLL:
    """csrc/lmu_bf16.cu's entries: the float32 ones' arguments, _bf16 names."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccvpe_lmu_fwd_bf16.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.ccvpe_lmu_bwd_plan_bf16.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 5
    lib.ccvpe_lmu_bwd_bf16.argtypes = [p] * 14 + [i] * 12 + [p]
    lib.ccvpe_mma_probe_bf16.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.ccvpe_mma_rate_bf16.argtypes = [i] * 2 + [p] * 3
    for name in ("ccvpe_lmu_fwd_bf16", "ccvpe_lmu_bwd_plan_bf16", "ccvpe_lmu_bwd_bf16",
                 "ccvpe_mma_probe_bf16", "ccvpe_mma_rate_bf16"):
        getattr(lib, name).restype = i
    return lib


def _entry(lib: ctypes.CDLL, name: str, bf16: bool):
    """The C entry `name` of the float32 library, or its bf16 twin."""
    return getattr(lib, name + "_bf16" if bf16 else name)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build csrc/lmu.cu for sm_90a at first use and bind its C entries."""
    from ccvpe_tpu_torch.csrc.build import build
    return _bind(build("lmu").path)


@functools.cache
def load_bf16_library() -> ctypes.CDLL:
    """Build csrc/lmu_bf16.cu (the bf16 kernels) at first use."""
    from ccvpe_tpu_torch.csrc.build import build
    return _bind_bf16(build(BF16_SOURCE).path)


def _library(bf16: bool) -> ctypes.CDLL:
    return load_bf16_library() if bf16 else load_library()


@functools.cache
def load_timed_library() -> ctypes.CDLL:
    """The same source built with the backward's per-phase timer."""
    from ccvpe_tpu_torch.csrc.build import build
    return _bind_timed(build("lmu", (PHASE_TIMER,)).path)


@functools.cache
def load_timed_bf16_library() -> ctypes.CDLL:
    """The bf16 kernels built with the backward's per-phase timer."""
    from ccvpe_tpu_torch.csrc.build import build
    return _bind_timed(build(BF16_SOURCE, (PHASE_TIMER,)).path, bf16=True)


def _bind_timed(path, bf16: bool = False) -> ctypes.CDLL:
    """_bind (bf16: _bind_bf16), and the timed build's entries."""
    lib = (_bind_bf16 if bf16 else _bind)(path)
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


ACT_DTYPES = (torch.float32, torch.bfloat16)


def _act_dtype(x: torch.Tensor) -> torch.dtype:
    """The stage's activation type: x's, float32 or bf16."""
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    return x.dtype


def _check(name: str, t: torch.Tensor, device, dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
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
    """torch layouts -> the float32 kernels' operands (phase di*2+dj, tap
    ky*3+kx): wd [4][Cin][Cd], w1 [9][C][C1], w2 [9][C1][Cout] and, for the
    backward, the flipped-transposed w2T [9][Cout][C1] and w1T [9][C1][C] of
    the transposed convs and wdT [4][Cd][Cin] of dx (the TPU kernel's
    _flipT), each with its last dimension padded with zeros to pad_co
    columns, so that the kernels copy an operand as one flat run of 16-byte
    transfers."""
    return tuple(_padded(t) for t in kernel_weights_unpadded(wd, w1, w2))


def kernel_weights_unpadded(wd: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """kernel_weights' six operands in float32, [tap][K][N], unpadded."""
    wd, w1, w2 = wd.detach().float(), w1.detach().float(), w2.detach().float()
    cin, cd = wd.shape[:2]
    c1, c = w1.shape[:2]
    cout = w2.shape[0]
    return (wd.permute(2, 3, 0, 1).reshape(4, cin, cd),
            w1.permute(2, 3, 1, 0).reshape(9, c, c1),
            w2.permute(2, 3, 1, 0).reshape(9, c1, cout),
            w2.flip(2, 3).permute(2, 3, 0, 1).reshape(9, cout, c1),
            w1.flip(2, 3).permute(2, 3, 0, 1).reshape(9, c1, c),
            wd.permute(2, 3, 1, 0).reshape(4, cd, cin))


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
    Same contract as fused_stage_plain, for float32 activations (the bf16
    kernel's is fused_stage_bf16_split_plain)."""
    wd, w1, w2 = (t.detach().float() for t in (wd, w1, w2))
    h = _deconv_split(x.detach().float(), wd, bd.detach())
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
    as fused_stage_bwd_plain, for float32 activations (the bf16 kernel's
    is fused_stage_bwd_bf16_split_plain)."""
    b, hc, wc, cin = x.shape
    cd, c1, cout = wd.shape[1], w1.shape[0], w2.shape[0]
    wd, w1, w2 = (t.detach().float() for t in (wd, w1, w2))
    x, dy = x.detach().float(), dy.detach().float()
    h = _deconv_split(x, wd, bd.detach())
    if skip is not None:
        h = torch.cat([h, skip.detach().float()], dim=-1)
    c = h.shape[-1]
    g = torch.relu(_conv3x3_split(h, w1, tensor_core_conv(c1)) + b1.detach())
    # the transposed convs: torch weights (C_out, C_in, 3, 3) of flipT(w)
    da = _conv3x3_split(dy, w2.flip(2, 3).transpose(0, 1), bwd_tensor_core_conv(c1, cout))
    da = torch.where(g > 0, da, torch.zeros_like(da))
    dhs = _conv3x3_split(da, w1.flip(2, 3).transpose(0, 1), bwd_tensor_core_conv(c, c1))
    dh, dskip = dhs[..., :cd], (dhs[..., cd:] if skip is not None else None)
    dbd = dh.sum((0, 1, 2))
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
    return (dx, dskip, dwd.permute(2, 3, 0, 1), dbd, dw1, da.sum((0, 1, 2)), dw2,
            dy.sum((0, 1, 2)))


# --- the bf16 kernels (csrc/lmu_bf16.cu) ---------------------------------

# Fine tiles of the bf16 B2 and B3, largest first; threads of B3's block;
# m-tiles of 16 pixels in a conv item of B2 (csrc/lmu_bf16.cu's kBwdThreads,
# kFwdMTiles).
BF16_TILES = (16, 8, 4)
BF16_BWD_THREADS = 512
BF16_FWD_MTILES = 2


def bf16_bwd_mtiles(nt: int) -> int:
    """m-tiles of 16 pixels in one warp item of a bf16 B3 conv whose items
    hold nt n-tiles (csrc/lmu_bf16.cu::bwd_mtiles)."""
    return 2 if nt <= 3 else 1


def pix_stride(c: int) -> int:
    """bf16 values from one pixel's row to the next in a bf16 plane of c
    channels (and from one K row to the next in a bf16 weight operand of c
    output channels), csrc/lmu_bf16.cu::pix_stride: c rounded up to 8, and 8
    more where that is an even number of 16-byte units, so that 8
    neighbouring rows start in 8 distinct 16-byte bank groups."""
    r = -(-c // 8) * 8
    return r if r // 8 % 2 else r + 8


def plane_size(npix: int, c: int) -> int:
    """bf16 values of a plane of npix pixels of c channels, with its
    16-byte tail (csrc/lmu_bf16.cu::plane_size)."""
    return npix * pix_stride(c) + 8


def n_group(n: int) -> int:
    """n-tiles of 8 channels in one warp item of a bf16 conv or weight
    gradient with n output channels (csrc/lmu_bf16.cu::n_group): all of them
    up to 5, else the fewest groups of at most 5, evened out."""
    tiles = -(-n // 8)
    groups = -(-tiles // 5)
    return -(-tiles // groups)


def _zero_size(cin, cs, cd, c1, cout) -> int:
    return max(pix_stride(c) for c in (cin, cd + cs, cd, c1, cout)) + 16


def bf16_fwd_smem_bytes(cin: int, cs: int, cd: int, c1: int, cout: int, t: int) -> int:
    """Dynamic shared memory of the bf16 B2 at fine tile t
    (csrc/lmu_bf16.cu::fwd_layout): the zero region; h|skip planes on
    (t+4)^2, later w2; the coarse x planes, later g on (t+2)^2; wd, later w1."""
    c, hs, gs = cd + cs, t + 4, t + 2
    a = max(plane_size(hs * hs, c), 9 * c1 * pix_stride(cout))
    b = max(plane_size((hs // 2) ** 2, cin), plane_size(gs * gs, c1))
    w = max(4 * cin * pix_stride(cd), 9 * c * pix_stride(c1))
    return 2 * (_zero_size(cin, cs, cd, c1, cout) + a + b + w)


def bf16_fwd_tile(cin: int, cs: int, cd: int, c1: int, cout: int,
                  limit: int = MAX_BLOCK_SMEM) -> int:
    """The fine tile the bf16 B2 picks (ccvpe_lmu_fwd_bf16 with t = 0): the
    largest of BF16_TILES whose shared memory fits in `limit` bytes."""
    for t in BF16_TILES:
        if bf16_fwd_smem_bytes(cin, cs, cd, c1, cout, t) <= limit:
            return t
    raise ValueError("the stage's planes and weights fit no tile")


def bf16_bwd_weight_sizes(cin: int, cs: int, cd: int, c1: int, cout: int) -> Tuple[int, ...]:
    """bf16 values of the bf16 B3's weight operands wd, w1, w2T, w1T, wdT
    ([tap][K][pix_stride(N)], csrc/lmu_bf16.cu::bwd_weight_size)."""
    c = cd + cs
    return (4 * cin * pix_stride(cd), 9 * c * pix_stride(c1), 9 * cout * pix_stride(c1),
            9 * c1 * pix_stride(c), 4 * cd * pix_stride(cin))


def bf16_bwd_smem_bytes(cin: int, cs: int, cd: int, c1: int, cout: int, t: int,
                        weights: str = "one buffer", ahead: bool = False) -> int:
    """Dynamic shared memory of the bf16 B3 at fine tile t with its weights
    kept as `weights` (one of WEIGHT_MODES) and the planes copied a tile
    ahead or not (csrc/lmu_bf16.cu::bwd_layout): the zero region; hc and dy
    on (t+4)^2, g and da on (t+2)^2, x on ((t+4)/2)^2, dh on t^2; dbd's
    column sums; the weights; the second dy and x planes when ahead."""
    c, hs, gs, xs = cd + cs, t + 4, t + 2, (t + 4) // 2
    planes = (plane_size(hs * hs, c) + plane_size(gs * gs, c1) + plane_size(hs * hs, cout)
              + plane_size(gs * gs, c1) + plane_size(xs * xs, cin) + plane_size(t * t, cd))
    dbd = -(-2 * -(-t * t // 16) * cd // 8) * 8
    sizes = bf16_bwd_weight_sizes(cin, cs, cd, c1, cout)
    w = {"resident": sum(sizes), "two buffers": 2 * max(sizes), "one buffer": max(sizes)}[weights]
    more = plane_size(hs * hs, cout) + plane_size(xs * xs, cin) if ahead else 0
    return 2 * (_zero_size(cin, cs, cd, c1, cout) + planes + dbd + w + more)


def bf16_bwd_tile(cin: int, cs: int, cd: int, c1: int, cout: int,
                  limit: int = MAX_BLOCK_SMEM) -> int:
    """The fine tile the bf16 B3's plan picks (ccvpe_lmu_bwd_plan_bf16): the
    largest of BF16_TILES whose planes and one weight buffer fit in `limit`
    bytes."""
    for t in BF16_TILES:
        if bf16_bwd_smem_bytes(cin, cs, cd, c1, cout, t) <= limit:
            return t
    raise ValueError("the stage's planes and weights fit no tile")


def kernel_weights_bf16(wd: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """torch layouts -> the bf16 kernels' operands, bf16, [tap][K][
    pix_stride(N)] with zeros past N: wd [4][Cin][Cd], w1 [9][C][C1], w2 [9][
    C1][Cout], and for the backward w2T [9][Cout][C1], w1T [9][C1][C], wdT [4][
    Cd][Cin] (kernel_weights' operands, each value rounded to bf16, as the
    TPU kernel casts them)."""
    return tuple(F.pad(t, (0, pix_stride(t.shape[-1]) - t.shape[-1])).to(torch.bfloat16)
                 .contiguous() for t in kernel_weights_unpadded(wd, w1, w2))


def _taps_bf16(cols, w: torch.Tensor) -> torch.Tensor:
    """sum over taps of cols[tap] [P, K] @ w[tap] [K, N] as the bf16 kernels'
    conv_tc sums it: tap by tap, and within a tap k-steps of 16 channels,
    each a float32 sum of its 16 exact products, added in that order into
    one float32 sum."""
    acc = torch.zeros(cols[0].shape[0], w.shape[2], dtype=torch.float32, device=cols[0].device)
    for tap, a in enumerate(cols):
        for k0 in range(0, a.shape[1], 16):
            acc = acc + a[:, k0:k0 + 16] @ w[tap, k0:k0 + 16]
    return acc


def _conv3x3_bf16(inp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3x3 of NHWC `inp` with zero padding against the operand w [9][C][N]
    (tap ky*3 + kx), as _taps_bf16."""
    b, h, wd_, c = inp.shape
    pad = F.pad(inp, (0, 0, 1, 1, 1, 1))
    cols = [pad[:, ky:ky + h, kx:kx + wd_, :].reshape(-1, c) for ky in range(3) for kx in range(3)]
    return _taps_bf16(cols, w).reshape(b, h, wd_, w.shape[2])


def _bf16_forward_parts(x, skip, wd, bd, w1, b1, w2):
    """(the six operands of kernel_weights_unpadded rounded to bf16, [h |
    skip], g) of the bf16 kernels' forward up to g."""
    ops = tuple(round_bf16(t) for t in kernel_weights_unpadded(wd, w1, w2))
    b, hc, wc, cin = x.shape
    xm = x.detach().float().reshape(-1, cin)
    h = torch.stack([_taps_bf16([xm], ops[0][ph:ph + 1]).reshape(b, hc, wc, -1)
                     for ph in range(4)], dim=3)                  # [b, hc, wc, (di, dj), cd]
    h = h.reshape(b, hc, wc, 2, 2, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * hc, 2 * wc, -1)
    h = round_bf16(h + bd.detach())
    if skip is not None:
        h = torch.cat([h, skip.detach().float()], dim=-1)
    g = torch.relu(round_bf16(_conv3x3_bf16(h, ops[1]) + b1.detach()))
    return ops, h, g


def fused_stage_bf16_split_plain(x: torch.Tensor, skip: Optional[torch.Tensor], wd: torch.Tensor,
                                 bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                                 w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """What the bf16 B2 (csrc/lmu_bf16.cu) computes, in plain torch: every
    conv on bf16 values with K in the kernel's order (_taps_bf16: tap by
    tap, k-steps of 16, one float32 sum), the deconv's four phases as four
    one-tap convs; h and conv_a + b1 rounded to bf16, the ReLU after;
    biases added after each sum. y float32 [B, 2Hc, 2Wc, Cout]."""
    ops, _, g = _bf16_forward_parts(x, skip, wd, bd, w1, b1, w2)
    return _conv3x3_bf16(g, ops[2]) + b2.detach()


def fused_stage_bwd_bf16_split_plain(x: torch.Tensor, skip: Optional[torch.Tensor],
                                     dy: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                                     b2: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """What the bf16 B3 computes, in plain torch: h and g recomputed as
    fused_stage_bf16_split_plain does; da = relu'(a) * conv3x3(dy, w2T),
    [dh | dskip] = conv3x3(da, w1T) and dx (dh's four phases, the taps of a
    one-pixel conv against wdT), each as _taps_bf16 sums them; roundings where
    the kernel rounds (dy, da after the mask, dh after dbd's float32 sums,
    dskip and dx as they are stored). The weight gradients as float32 sums
    of exact products over the pixels, in the matmul's order (the kernel's
    per-tile order is not emulated: on dyadic inputs every order gives the
    same bits); the bias gradients as float32 sums. Same contract as
    fused_stage_bwd_plain: dx and dskip bf16, the rest float32."""
    b, hc, wc, cin = x.shape
    cd, c1, cout = wd.shape[1], w1.shape[0], w2.shape[0]
    (_, _, _, w2t, w1t, wdt), h, g = _bf16_forward_parts(x, skip, wd, bd, w1, b1, w2)
    dy = round_bf16(dy.detach().float())
    c = h.shape[-1]
    da = round_bf16(torch.where(g > 0, _conv3x3_bf16(dy, w2t), torch.zeros_like(g)))
    dhs = _conv3x3_bf16(da, w1t)
    dh, dskip = dhs[..., :cd], (dhs[..., cd:].to(torch.bfloat16) if skip is not None else None)
    dbd = dh.sum((0, 1, 2))
    dh = round_bf16(dh)
    phases = [dh[:, di::2, dj::2, :].reshape(-1, cd) for di in range(2) for dj in range(2)]
    dx = _taps_bf16(phases, wdt).reshape(b, hc, wc, cin).to(torch.bfloat16)

    def wgrad(inp, out):                                          # inp^T out over pixels
        return inp.t() @ out

    pad = F.pad(g, (0, 0, 1, 1, 1, 1))
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    h2, w2_ = 2 * hc, 2 * wc
    dym, dam = dy.reshape(-1, cout), da.reshape(-1, c1)
    dw2 = torch.stack([wgrad(pad[:, ky:ky + h2, kx:kx + w2_].reshape(-1, c1), dym)
                       for ky in range(3) for kx in range(3)]).reshape(3, 3, c1, cout)
    dw1 = torch.stack([wgrad(hp[:, ky:ky + h2, kx:kx + w2_].reshape(-1, c), dam)
                       for ky in range(3) for kx in range(3)]).reshape(3, 3, c, c1)
    xm = x.detach().float().reshape(-1, cin)
    dwd = torch.stack([wgrad(xm, ph) for ph in phases]).reshape(2, 2, cin, cd)
    return (dx, dskip, dwd.permute(2, 3, 0, 1), dbd, dw1.permute(3, 2, 0, 1), da.sum((0, 1, 2)),
            dw2.permute(3, 2, 0, 1), dy.sum((0, 1, 2)))


def pad_channels(t: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """t [..., C] -> [..., C rounded up to `multiple`] with zeros in the
    added channels (t itself where C is a multiple): the bf16 kernels copy
    each pixel's row of x (multiple 8) and dy (multiple 2) into shared
    memory as 16-byte and 4-byte cp.async runs."""
    return F.pad(t, (0, -t.shape[-1] % multiple)) if t.shape[-1] % multiple else t


def _check_bf16_rows(acts) -> None:
    """(name, tensor) pairs of the bf16 kernels' activations (a None skip
    passes): each must start on a 16-byte boundary, as their pixel rows are
    copied by cp.async."""
    for name, t in acts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (cp.async copies)")


def _check_operand(name: str, t: torch.Tensor, device, dtype=torch.float32) -> None:
    _check(name, t, device, dtype)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (cp.async copies)")


def _check_inputs(dev, act, acts, biases) -> None:
    """(name, tensor) pairs: the activations in the stage's type `act`
    (a None skip passes), the biases in float32."""
    for name, t in acts:
        if t is not None:
            _check(name, t, dev, act)
    for name, t in biases:
        _check(name, t, dev)


@torch.library.custom_op("ccvpe_tpu_torch::lmu_fwd", mutates_args=())
def lmu_fwd(x: torch.Tensor, skip: Optional[torch.Tensor], wd: torch.Tensor, bd: torch.Tensor,
            w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            tile: int) -> torch.Tensor:
    """B2's forward as a registered op: y NHWC [B, 2Hc, 2Wc, Cout] float32.
    This implementation serves every device but CUDA: the plain version.
    The CUDA one (_lmu_fwd_cuda) launches the kernel."""
    return fused_stage_plain(x, skip, wd, bd, w1, b1, w2, b2)


@lmu_fwd.register_fake
def _lmu_fwd_fake(x, skip, wd, bd, w1, b1, w2, b2, tile):
    b, hc, wc, _ = x.shape
    return x.new_empty((b, 2 * hc, 2 * wc, w2.shape[0]), dtype=torch.float32)


@lmu_fwd.register_kernel("cuda")
def _lmu_fwd_cuda(x, skip, wd, bd, w1, b1, w2, b2, tile):
    """The kernel launch, counted in fused_stage.launches (float32 x) or
    fused_stage.bf16_launches (bf16 x)."""
    b, hc, wc, cin, cs, cd, c1, cout = _dims(x, skip, wd, w1, w2)
    dev, act = x.device, _act_dtype(x)
    bf16 = act == torch.bfloat16
    _check_inputs(dev, act, (("x", x), ("skip", skip)), (("bd", bd), ("b1", b1), ("b2", b2)))
    wdk, w1k, w2k = (kernel_weights_bf16(wd, w1, w2) if bf16 else kernel_weights(wd, w1, w2))[:3]
    for name, t in (("wd", wdk), ("w1", w1k), ("w2", w2k)):
        _check_operand(name, t, dev, t.dtype)
    entry = _entry(_library(bf16), "ccvpe_lmu_fwd", bf16)
    y = torch.empty((b, 2 * hc, 2 * wc, cout), device=dev, dtype=torch.float32)
    xk = pad_channels(x) if bf16 else x
    if bf16:
        _check_bf16_rows((("x", xk), ("skip", skip)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(xk.data_ptr(), _ptr(skip), wdk.data_ptr(), bd.data_ptr(), w1k.data_ptr(),
                   b1.data_ptr(), w2k.data_ptr(), b2.data_ptr(), y.data_ptr(), b, hc, wc, cin,
                   cs, cd, c1, cout, tile, stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error {rc}")
    if bf16:
        fused_stage.bf16_launches += 1
    else:
        fused_stage.launches += 1
    return y


def fused_stage(x: torch.Tensor, skip: Optional[torch.Tensor], wd: torch.Tensor,
                bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, tile: int = 0) -> torch.Tensor:
    """The op lmu_fwd: kernel B2 on a CUDA tensor, fused_stage_plain on a
    CPU one: y NHWC [B, 2Hc, 2Wc, Cout] float32. x (and skip) float32 or
    bf16 (the bf16 kernel, ops/lmu.py's bf16 policy). Counts launches in
    fused_stage.launches, bf16 ones in fused_stage.bf16_launches. `tile` 0
    lets the kernel pick its fine tile T (fwd_tile); 16, 8 or 4 forces it,
    for the checks that y does not depend on T. Differentiable: the
    backward is fused_stage_bwd."""
    if tile not in (0,) + FWD_TILES:
        raise ValueError(f"tile must be 0 or one of {FWD_TILES}, got {tile}")
    return lmu_fwd(x, skip, wd, bd, w1, b1, w2, b2, tile)


fused_stage.launches = 0
fused_stage.bf16_launches = 0
register_launches("lmu_fwd", fused_stage)
register_launches("lmu_fwd.bf16", fused_stage, "bf16_launches")


def fused_stage_bwd(x: torch.Tensor, skip: Optional[torch.Tensor], dy: torch.Tensor,
                    wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """Kernel B3 on a CUDA tensor, fused_stage_bwd_plain on a CPU one:
    (dx, dskip or None, dwd, dbd, dw1, db1, dw2, db2), weights' grads in
    torch layouts, float32; dx and dskip in x's type. With a bf16 x, dy is
    rounded to bf16 first (the TPU kernel's :440). Counts launches in
    fused_stage_bwd.launches, bf16 ones in fused_stage_bwd.bf16_launches."""
    if not x.is_cuda:
        return fused_stage_bwd_plain(x, skip, dy, wd, bd, w1, b1, w2, b2)
    bf16 = _act_dtype(x) == torch.bfloat16
    if bf16:
        dy = dy.to(torch.bfloat16).contiguous()
    grads, _ = _launch_bwd(_library(bf16), x, skip, dy, wd, bd, w1, b1, w2, b2)
    if bf16:
        fused_stage_bwd.bf16_launches += 1
    else:
        fused_stage_bwd.launches += 1
    return grads


fused_stage_bwd.launches = 0
fused_stage_bwd.bf16_launches = 0
register_launches("lmu_bwd", fused_stage_bwd)
register_launches("lmu_bwd.bf16", fused_stage_bwd, "bf16_launches")


def bwd_phase_cycles(x: torch.Tensor, skip: Optional[torch.Tensor], dy: torch.Tensor,
                     wd: torch.Tensor, bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor):
    """B3 built with its per-phase timer, on CUDA tensors only (the timer
    is a clock on the card): (the grads as fused_stage_bwd returns them,
    int64 [blocks, len(BWD_PHASES)] clock64 cycles each block spent in each
    phase, summed over its tiles). A bf16 x times the bf16 kernel (dy
    rounded to bf16 first, as fused_stage_bwd does). Not counted in
    fused_stage_bwd.launches: the main path runs the untimed libraries."""
    if not x.is_cuda:
        raise ValueError("the phase timer runs on the card: pass CUDA tensors")
    if _act_dtype(x) == torch.bfloat16:
        dy = dy.to(torch.bfloat16).contiguous()
        return _launch_bwd(load_timed_bf16_library(), x, skip, dy, wd, bd, w1, b1, w2, b2,
                           timed=True)
    return _launch_bwd(load_timed_library(), x, skip, dy, wd, bd, w1, b1, w2, b2, timed=True)


def _launch_bwd(lib, x, skip, dy, wd, bd, w1, b1, w2, b2, timed=False):
    b, hc, wc, cin, cs, cd, c1, cout = _dims(x, skip, wd, w1, w2)
    if tuple(dy.shape) != (b, 2 * hc, 2 * wc, cout):
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected {(b, 2 * hc, 2 * wc, cout)}")
    dev, act = x.device, _act_dtype(x)
    bf16 = act == torch.bfloat16
    _check_inputs(dev, act, (("x", x), ("skip", skip), ("dy", dy)), (("bd", bd), ("b1", b1)))
    wdk, w1k, _, w2t, w1t, wdt = kernel_weights_bf16(wd, w1, w2) if bf16 else kernel_weights(
        wd, w1, w2)
    for name, t in (("wd", wdk), ("w1", w1k), ("w2t", w2t), ("w1t", w1t), ("wdt", wdt)):
        _check_operand(name, t, dev, t.dtype)
    with torch.cuda.device(dev):
        t_, mode, ahead, nblk, psize = _plan(lib, b, hc, wc, cin, cs, cd, c1, cout, bf16)
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
        entry = _entry(lib, "ccvpe_lmu_bwd", bf16)
        xk, dyk = (pad_channels(x), pad_channels(dy, 2)) if bf16 else (x, dy)
        if bf16:
            _check_bf16_rows((("x", xk), ("skip", skip), ("dy", dyk)))
        rc = entry(xk.data_ptr(), _ptr(skip), dyk.data_ptr(), wdk.data_ptr(), bd.data_ptr(),
                   w1k.data_ptr(), b1.data_ptr(), w2t.data_ptr(), w1t.data_ptr(),
                   wdt.data_ptr(), dx.data_ptr(), _ptr(dskip), part.data_ptr(),
                   sums.data_ptr(), b, hc, wc, cin, cs, cd, c1, cout, t_, mode, ahead, nblk,
                   stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error {rc}")
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


def _plan(lib, b, hc, wc, cin, cs, cd, c1, cout, bf16=False):
    """ccvpe_lmu_bwd_plan (bf16: its bf16 twin) on the current device: (T,
    weight mode, planes copied a tile ahead (0 or 1), blocks, floats of a
    block's partial slice)."""
    out = [ctypes.c_int(0) for _ in range(5)]
    rc = _entry(lib, "ccvpe_lmu_bwd_plan", bf16)(b, hc, wc, cin, cs, cd, c1, cout,
                                                 *map(ctypes.byref, out))
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
        bf16 = _act_dtype(x) == torch.bfloat16
        t, mode, ahead, nblk, _ = _plan(_library(bf16), b, hc, wc, cin, cs, cd, c1, cout, bf16)
    return dict(t=t, weights=WEIGHT_MODES[mode], planes_ahead=bool(ahead), blocks=nblk,
                tiles=b * -(-2 * hc // t) * -(-2 * wc // t))


def _lmu_fwd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:8])


def _lmu_fwd_backward(ctx, dy):
    """fused_stage_bwd from the saved inputs: the 2x-resolution
    intermediates never persist."""
    x, skip, wd, bd, w1, b1, w2, b2 = ctx.saved_tensors
    return (*fused_stage_bwd(x, skip, dy.contiguous(), wd, bd, w1, b1, w2, b2), None)


lmu_fwd.register_autograd(_lmu_fwd_backward, setup_context=_lmu_fwd_setup)


def mma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] float32 through one of the kernels' tensor-core
    primitives (one block, operands in shared memory) on CUDA tensors: float32
    a and b through the 3xTF32 mma.sync of csrc/lmu.cu, bf16 ones through the
    bf16 mma.sync.m16n8k16 and ldmatrix loads of csrc/lmu_bf16.cu. On CPU
    tensors the plain versions: matmul_3xtf32_plain, and for bf16 a.float() @
    b.float() (exact products, float32 sums in another order). Counts
    launches in mma_probe.launches."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected [M, K] @ [K, N], got {tuple(a.shape)} @ {tuple(b.shape)}")
    bf16 = _act_dtype(a) == torch.bfloat16
    if not a.is_cuda:
        return a.float() @ b.float() if bf16 else matmul_3xtf32_plain(a, b)
    for name, t in (("a", a), ("b", b)):
        _check(name, t, a.device, a.dtype)
    (m, k), n = a.shape, b.shape[1]
    entry = _entry(_library(bf16), "ccvpe_mma_probe", bf16)
    c = torch.empty((m, n), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = entry(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error {rc}")
    mma_probe.launches += 1
    return c


mma_probe.launches = 0


def mma_rate(iters: int = 20000, bf16: bool = False) -> dict:
    """The card's issue rate of the mma.sync the kernels' products are made
    of: the m16n8k8 TF32 one (csrc/lmu.cu::mma_rate_kernel), or with bf16 the
    m16n8k16 bf16 one (csrc/lmu_bf16.cu::mma_rate_bf16_kernel); one block of
    16 warps per SM, each warp 8 independent products per round, no loads:
    ms, clock64 cycles per product per SM sub-partition (4 per SM), and
    TFLOP/s (2048 flops a TF32 product, 4096 a bf16 one). On the card only."""
    if not torch.cuda.is_available():
        raise ValueError("the rate is the card's: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _library(bf16)
    rate = _entry(lib, "ccvpe_mma_rate", bf16)
    out = torch.empty(sms * 512, device=dev)
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n in (100, iters):                          # the first launch warms up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = rate(sms, n, out.data_ptr(), cycles.data_ptr(), stream)
        end.record()
        if rc != 0:
            raise RuntimeError(f"{rate.__name__} launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    per_sm = 16 * 8 * iters
    return dict(ms=ms, cycles_per_mma_per_smsp=float(cycles.double().mean()) / (per_sm / 4),
                tflops=per_sm * sms * (4096 if bf16 else 2048) / ms / 1e9)
