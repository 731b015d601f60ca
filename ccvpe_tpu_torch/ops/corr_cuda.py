"""Fused rolled correlation on Hopper: the wrapper of csrc/corr.cu, the port
of the Pallas kernel ccvpe_tpu/ops/corr_pallas.py::_corr_kernel (launched
by _corr_fwd_pallas, :70-110).

With the ground norm folded into the descriptor matrix (G' = G / ||g||),
the kernel computes per sat pixel t and bin k

    num[t,k]  = sum_d S[t,d] * G'[k,d]
    den2[t,k] = sum_d S[t,d]^2 * M[k,d]
    out[t,k]  = num * rsqrt(den2)        (and r = rsqrt(den2) if asked)

reading S once, its products in 3xTF32 on the tensor cores. `corr_plan`
sizes a launch (rows per tile, slices of D, K padded to a multiple of 8,
blocks); `corr_core_split_plain` repeats the kernel's arithmetic in plain
torch. The CUDA route is a plain C interface built with nvcc
(csrc/build.py) and loaded with ctypes; nothing here touches nvcc or the
card until a CUDA tensor arrives, so the module imports on a CPU-only host.
On a CPU tensor `corr_core` runs `corr_core_plain`.

The kernel writes through raw pointers, so its output carries no autograd
graph of its own: `CorrCore` (an autograd.Function whose backward is the
plain products of corr_pallas.py:124-135) gives it one, and
`rolled_corr_cuda` goes through it whenever a gradient is wanted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from ccvpe_tpu_torch.ops.corr import build_roll_matrices
from ccvpe_tpu_torch.ops.tf32 import split_tf32

MAX_BINS = 32   # csrc/corr.cu kMaxBins
# csrc/corr.cu's tile, ring and the shared memory of one block (smem_bytes)
ROWS, CHUNK, STAGES = 64, 40, 2      # kRows, kChunk, kStages
H100_SMS = 132
SM_SMEM, BLOCK_SMEM_RESERVED, MAX_BLOCK_SMEM = 233472, 1024, 232448   # sm_90
RECORD_BYTES = 65536    # cap on a block's G' hi, G' lo and M rows: it bounds a slice's width
MAX_BLOCKS_PER_SM = 5   # kMinBlocks: __launch_bounds__ keeps 5 blocks' registers on an SM


def smem_bytes(width: int, k: int, kp: int) -> int:
    """Shared memory of one kernel block (csrc/corr.cu::smem_bytes): the S
    ring, G' hi, G' lo and M as kp rows of width + 4 floats each, the out
    and r staging."""
    return 4 * STAGES * ROWS * (CHUNK + 4) + 4 * 3 * kp * (width + 4) + 4 * 2 * ROWS * k


@dataclasses.dataclass(frozen=True)
class CorrPlan:
    rows: int            # T: sat rows per tile
    slices: int          # slices of D, each a block's own
    kp: int              # K padded to a multiple of 8
    width: int           # channels per slice (the last may hold fewer)
    grid_x: int          # blocks along the row tiles of one (batch, slice)
    blocks_per_sm: int   # resident blocks per SM that the grid assumes
    blocks: int          # grid_x * slices * B


@functools.lru_cache(maxsize=256)
def corr_plan(b: int, n: int, d: int, k: int, sms: int = H100_SMS) -> CorrPlan:
    """The kernel's launch for S [b, n, d] and k bins on a card of `sms` SMs.
    Row tiles of ROWS; where the b * tiles blocks fall short of one block
    per SM, D is split into slices of a multiple of 8 channels until they
    do not, and where D is wider than a block's G'/M rows hold
    (RECORD_BYTES), into slices that fit (each slice then writes partial
    sums that a second kernel adds). The grid is at most one wave of
    resident blocks (per SM: as many as the shared memory holds, at most
    MAX_BLOCKS_PER_SM), each taking an equal share of the row tiles."""
    if not 1 <= k <= MAX_BINS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_BINS} bins, got K={k}")
    if min(b, n, d) < 1:
        raise ValueError(f"empty S [{b}, {n}, {d}]")
    kp = -(-k // 8) * 8
    tiles = -(-n // ROWS)
    widest = RECORD_BYTES // (12 * kp) // 8 * 8
    want = -(-sms // (b * tiles))                 # slices for one block per SM
    width = -(-d // 8) * 8 if want == 1 else max(8, d // want // 8 * 8)
    width = min(width, widest)
    slices = -(-d // width)
    per_sm = min(MAX_BLOCKS_PER_SM,
                 SM_SMEM // (smem_bytes(width, k, kp) + BLOCK_SMEM_RESERVED))
    cap = max(1, per_sm * sms // (slices * b))
    per_block = -(-tiles // min(tiles, cap))
    grid_x = -(-tiles // per_block)
    return CorrPlan(ROWS, slices, kp, width, grid_x, per_sm, grid_x * slices * b)


def corr_core_plain(s_flat: torch.Tensor, g_mat: torch.Tensor,
                    m_mat: torch.Tensor, need_r: bool = False):
    """Plain torch version of the kernel: s_flat [B,N,D], g_mat [B,K,D]
    (already / ||g||), m_mat [K,D] -> out [B,N,K] (and r [B,N,K])."""
    num = torch.bmm(s_flat, g_mat.transpose(1, 2))
    den2 = torch.matmul(s_flat * s_flat, m_mat.t())
    r = torch.rsqrt(den2)
    out = num * r
    return (out, r) if need_r else out


def corr_core_split_plain(s_flat: torch.Tensor, g_mat: torch.Tensor,
                          m_mat: torch.Tensor, plan: CorrPlan, need_r: bool = False):
    """The kernel's arithmetic in plain torch: per slice of plan.width
    channels, num from three TF32 products (S lo.G' hi + S hi.G' lo, then
    S hi.G' hi) and den2 from two (S^2 lo.M, then S^2 hi.M; M is exact in
    TF32), each product exact in float32; the slices' partial sums added in
    slice order. Sums inside a product run in the matmul's order, not the
    tensor cores'. Same contract as corr_core_plain."""
    d = s_flat.shape[-1]
    num = den2 = 0
    for lo in range(0, d, plan.width):
        s = s_flat[..., lo:lo + plan.width]
        g = g_mat[..., lo:lo + plan.width].transpose(1, 2)
        m = m_mat[:, lo:lo + plan.width].t()
        s_hi, s_lo = split_tf32(s)
        q_hi, q_lo = split_tf32(s * s)
        g_hi, g_lo = split_tf32(g.contiguous())
        num = num + ((s_lo @ g_hi + s_hi @ g_lo) + s_hi @ g_hi)
        den2 = den2 + (q_lo @ m + q_hi @ m)
    r = torch.rsqrt(den2)
    out = num * r
    return (out, r) if need_r else out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build csrc/corr.cu for sm_90a at first use and bind its C entries."""
    from ccvpe_tpu_torch.csrc.build import build
    lib = ctypes.CDLL(str(build("corr").path))
    lib.ccvpe_corr_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                                   + [ctypes.c_void_p])
    lib.ccvpe_corr_fwd.restype = ctypes.c_int
    lib.ccvpe_corr_occupancy.argtypes = [ctypes.c_int] * 3
    lib.ccvpe_corr_occupancy.restype = ctypes.c_int
    return lib


def kernel_occupancy(plan: CorrPlan, k: int) -> int:
    """Resident kernel blocks per SM for `plan` on the current card (the
    occupancy API); plan.blocks_per_sm should not exceed it."""
    return load_library().ccvpe_corr_occupancy(plan.width, k, plan.kp)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def corr_core(s_flat: torch.Tensor, g_mat: torch.Tensor, m_mat: torch.Tensor,
              need_r: bool = False):
    """The fused kernel on a CUDA tensor, its plain version on a CPU one.
    Same contract as corr_core_plain; M must be exact in TF32 (0/1 window
    masks are). Counts calls in corr_core.launches: one a call, whether the
    plan launches one kernel or the kernel and the slice reduce."""
    if not s_flat.is_cuda:
        return corr_core_plain(s_flat, g_mat, m_mat, need_r)
    if s_flat.dim() != 3:
        raise ValueError(f"s_flat must be [B, N, D], got {tuple(s_flat.shape)}")
    b, n, d = s_flat.shape
    k = g_mat.shape[1] if g_mat.dim() == 3 else -1
    if not 1 <= k <= MAX_BINS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_BINS} bins, got K={k}")
    dev = s_flat.device
    _check("s_flat", s_flat, (b, n, d), dev)
    _check("g_mat", g_mat, (b, k, d), dev)
    _check("m_mat", m_mat, (k, d), dev)
    lib = load_library()
    plan = corr_plan(b, n, d, k, _sm_count(dev.index))
    out = torch.empty((b, n, k), device=dev, dtype=torch.float32)
    r = torch.empty_like(out) if need_r else None
    part = (torch.empty(plan.slices * b * n * 2 * plan.kp, device=dev, dtype=torch.float32)
            if plan.slices > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccvpe_corr_fwd(s_flat.data_ptr(), g_mat.data_ptr(),
                                m_mat.data_ptr(), out.data_ptr(),
                                r.data_ptr() if need_r else None,
                                part.data_ptr() if part is not None else None,
                                b, n, d, k, plan.kp, plan.width, plan.slices,
                                plan.grid_x, stream)
    if rc != 0:
        raise RuntimeError(f"ccvpe_corr_fwd launch failed: CUDA error {rc}")
    corr_core.launches += 1
    return (out, r) if need_r else out


corr_core.launches = 0


def corr_core_bwd(grad_out: torch.Tensor, s_flat: torch.Tensor, g_mat: torch.Tensor,
                  m_mat: torch.Tensor, out: torch.Tensor, r: torch.Tensor):
    """Gradients of corr_core w.r.t. S and G' from the saved out and r (the
    port of ccvpe_tpu/ops/corr_pallas.py::_corr_core_bwd, :124-135; plain
    products there too). d out / d S = r*G' - S * (out * r^2 * M)."""
    a = grad_out * r                                   # [B,N,K]
    c = grad_out * out * (r * r)                       # [B,N,K]
    grad_s = torch.bmm(a, g_mat) - s_flat * torch.matmul(c, m_mat)
    grad_g = torch.bmm(a.transpose(1, 2), s_flat)
    return grad_s, grad_g


class CorrCore(torch.autograd.Function):
    """Differentiable corr_core (the counterpart of the jax.custom_vjp
    corr_core, corr_pallas.py:113-138): the forward is the kernel with
    need_r on a CUDA tensor and corr_core_plain on a CPU one; the backward
    is corr_core_bwd. M gets no gradient."""

    @staticmethod
    def forward(ctx, s_flat, g_mat, m_mat):
        out, r = corr_core(s_flat, g_mat, m_mat, need_r=True)
        ctx.save_for_backward(s_flat, g_mat, m_mat, out, r)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        s_flat, g_mat, m_mat, out, r = ctx.saved_tensors
        grad_s, grad_g = corr_core_bwd(grad_out, s_flat, g_mat, m_mat, out, r)
        return grad_s, grad_g, None


def corr_core_diff(s_flat: torch.Tensor, g_mat: torch.Tensor,
                   m_mat: torch.Tensor) -> torch.Tensor:
    """corr_core's out with gradients to S and G' when either needs them;
    a forward without a graph launches the kernel without r."""
    if torch.is_grad_enabled() and (s_flat.requires_grad or g_mat.requires_grad):
        return CorrCore.apply(s_flat, g_mat, m_mat)
    return corr_core(s_flat, g_mat, m_mat)


def rolled_corr_cuda(sat: torch.Tensor, grd: torch.Tensor, shift: int,
                     num_bins: int, center: bool = False,
                     bins: Optional[Sequence[int]] = None) -> torch.Tensor:
    """ops.corr.rolled_corr through the fused kernel: sat [B,h,w,D] NHWC,
    grd [B,L] -> [B,h,w,K]."""
    if bins is None:
        bins = tuple(range(num_bins))
    sat = sat.float()
    grd = grd.float()
    b, h, w, d = sat.shape
    g_mat, m_mat = build_roll_matrices(grd, d, shift, tuple(bins), center)
    g_mat = g_mat / torch.linalg.vector_norm(grd, dim=-1)[:, None, None]
    # a view for channels_last activations, one copy otherwise
    s_flat = sat.reshape(b, h * w, d).contiguous()
    out = corr_core_diff(s_flat, g_mat.contiguous(), m_mat.contiguous())
    return out.reshape(b, h, w, len(bins))
