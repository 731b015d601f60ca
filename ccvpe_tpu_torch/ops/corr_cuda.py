"""Fused rolled correlation on Hopper: the wrapper of csrc/corr.cu, the port
of the Pallas kernel ccvpe_tpu/ops/corr_pallas.py::_corr_kernel (launched
by _corr_fwd_pallas, :70-110).

With the ground norm folded into the descriptor matrix (G' = G / ||g||),
the kernel computes per sat pixel t and bin k

    num[t,k]  = sum_d S[t,d] * G'[k,d]
    den2[t,k] = sum_d S[t,d]^2 * M[k,d]
    out[t,k]  = num * rsqrt(den2)        (and r = rsqrt(den2) if asked)

reading S once, its products in 3xTF32 on the tensor cores. S may be
float32 or bfloat16 (the decoder's maps under compute_dtype='bfloat16'):
the kernel reads bf16 S itself and computes the float32 cosine of the bf16
values, the same result as on S.float(); with `round_sq` (ModelConfig.
corr_bf16 at D < 128, ops/corr.py::bf16_rounding) it rounds S^2 to bf16 in
den2. `corr_plan` sizes a launch (rows per tile, slices of D, K padded to
a multiple of 8, blocks); `corr_core_split_plain` repeats the kernel's
arithmetic in plain torch. The CUDA route is a plain C interface built with nvcc
(csrc/build.py) and loaded with ctypes; nothing here touches nvcc or the
card until a CUDA tensor arrives, so the module imports on a CPU-only host.
The forward is the registered op `ccvpe_tpu_torch::corr_fwd` (importing
this module registers it): its CUDA implementation launches the kernel, its
implementation for other devices is `corr_core_plain`, and its fake one
gives the shapes, so `torch.export` records it as one node and a CUDA
graph captures its launch. `corr_core` calls it.

The kernel writes through raw pointers, so the op's gradient is registered
with it (`torch.library.register_autograd`, the counterpart of the
jax.custom_vjp corr_core, corr_pallas.py:113-138): the plain products of
corr_pallas.py:124-135 from the saved out and r, which the forward writes
only where a gradient is wanted (`corr_core_diff`). Its gradient of S comes
back in S's dtype; M gets none.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from ccvpe_tpu_torch.ops.corr import round_bf16, bf16_rounding, build_roll_matrices
from ccvpe_tpu_torch.ops.tf32 import split_tf32

MAX_BINS = 32   # csrc/corr.cu kMaxBins
# csrc/corr.cu's tile, ring and the shared memory of one block (smem_bytes)
ROWS, CHUNK, STAGES = 64, 40, 2      # kRows, kChunk, kStages
# elements per ring row by the bytes of an element of S (SRing<T>::kStride)
RING_STRIDE = {4: CHUNK + 4, 2: CHUNK + 16}
# csrc/corr.cu's S types: float32, bf16, bf16 with S^2 rounded to bf16
S_F32, S_BF16, S_BF16_ROUND_SQ = 0, 1, 2
H100_SMS = 132
SM_SMEM, BLOCK_SMEM_RESERVED, MAX_BLOCK_SMEM = 233472, 1024, 232448   # sm_90
RECORD_BYTES = 65536    # cap on a block's G' hi, G' lo and M rows: it bounds a slice's width
MAX_BLOCKS_PER_SM = 5   # kMinBlocks: __launch_bounds__ keeps 5 blocks' registers on an SM


def smem_bytes(width: int, k: int, kp: int, s_bytes: int = 4) -> int:
    """Shared memory of one kernel block (csrc/corr.cu::smem_bytes): the S
    ring (elements of s_bytes), G' hi, G' lo and M as kp rows of width + 4
    floats each, the out and r staging."""
    return (s_bytes * STAGES * ROWS * RING_STRIDE[s_bytes] + 4 * 3 * kp * (width + 4)
            + 4 * 2 * ROWS * k)


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
def corr_plan(b: int, n: int, d: int, k: int, sms: int = H100_SMS, s_bytes: int = 4) -> CorrPlan:
    """The kernel's launch for S [b, n, d] of s_bytes elements and k bins
    on a card of `sms` SMs.
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
                 SM_SMEM // (smem_bytes(width, k, kp, s_bytes) + BLOCK_SMEM_RESERVED))
    cap = max(1, per_sm * sms // (slices * b))
    per_block = -(-tiles // min(tiles, cap))
    grid_x = -(-tiles // per_block)
    return CorrPlan(ROWS, slices, kp, width, grid_x, per_sm, grid_x * slices * b)


def corr_core_plain(s_flat: torch.Tensor, g_mat: torch.Tensor,
                    m_mat: torch.Tensor, need_r: bool = False, round_sq: bool = False):
    """Plain torch version of the kernel: s_flat [B,N,D] (float32 or bf16,
    computed in G's dtype), g_mat [B,K,D] (already / ||g||), m_mat [K,D] ->
    out [B,N,K] (and r [B,N,K]); round_sq rounds S^2 to bf16 in den2."""
    s_flat = s_flat.to(g_mat.dtype)
    sq = s_flat * s_flat
    num = torch.bmm(s_flat, g_mat.transpose(1, 2))
    den2 = torch.matmul(round_bf16(sq) if round_sq else sq, m_mat.t())
    r = torch.rsqrt(den2)
    out = num * r
    return (out, r) if need_r else out


def corr_core_split_plain(s_flat: torch.Tensor, g_mat: torch.Tensor,
                          m_mat: torch.Tensor, plan: CorrPlan, need_r: bool = False,
                          round_sq: bool = False):
    """The kernel's arithmetic in plain torch: per slice of plan.width
    channels, num from three TF32 products (S lo.G' hi + S hi.G' lo, then
    S hi.G' hi) and den2 from two (S^2 lo.M, then S^2 hi.M; M is exact in
    TF32), each product exact in float32; the slices' partial sums added in
    slice order. A bf16 S is its own TF32 hi (its lo is 0), and so is S^2
    rounded to bf16. Sums inside a product run in the matmul's order, not
    the tensor cores'. Same contract as corr_core_plain."""
    d = s_flat.shape[-1]
    s_flat = s_flat.float()
    num = den2 = 0
    for lo in range(0, d, plan.width):
        s = s_flat[..., lo:lo + plan.width]
        g = g_mat[..., lo:lo + plan.width].transpose(1, 2)
        m = m_mat[:, lo:lo + plan.width].t()
        s_hi, s_lo = split_tf32(s)
        q_hi, q_lo = split_tf32(round_bf16(s * s) if round_sq else s * s)
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
    lib.ccvpe_corr_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                                   + [ctypes.c_void_p])
    lib.ccvpe_corr_fwd.restype = ctypes.c_int
    lib.ccvpe_corr_occupancy.argtypes = [ctypes.c_int] * 4
    lib.ccvpe_corr_occupancy.restype = ctypes.c_int
    return lib


def kernel_occupancy(plan: CorrPlan, k: int, s_type: int = S_F32) -> int:
    """Resident kernel blocks per SM for `plan` and an S of `s_type` on the
    current card (the occupancy API); plan.blocks_per_sm should not exceed
    it."""
    return load_library().ccvpe_corr_occupancy(plan.width, k, plan.kp, s_type)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device,
           dtypes=(torch.float32,)) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@torch.library.custom_op("ccvpe_tpu_torch::corr_fwd", mutates_args=())
def corr_fwd(s_flat: torch.Tensor, g_mat: torch.Tensor, m_mat: torch.Tensor, need_r: bool,
             round_sq: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's forward as a registered op: (out, r), r empty ([0]) without
    need_r. This implementation serves every device but CUDA: the plain
    version. The CUDA one (_corr_fwd_cuda) launches the kernel."""
    if need_r:
        return corr_core_plain(s_flat, g_mat, m_mat, True, round_sq)
    return (corr_core_plain(s_flat, g_mat, m_mat, False, round_sq),
            s_flat.new_empty((0,), dtype=torch.float32))


@corr_fwd.register_fake
def _corr_fwd_fake(s_flat, g_mat, m_mat, need_r, round_sq):
    b, n, _ = s_flat.shape
    out = s_flat.new_empty((b, n, g_mat.shape[1]), dtype=torch.float32)
    return out, (torch.empty_like(out) if need_r else s_flat.new_empty((0,), dtype=torch.float32))


@corr_fwd.register_kernel("cuda")
def _corr_fwd_cuda(s_flat, g_mat, m_mat, need_r, round_sq):
    """The kernel launch: one a call, whether the plan launches one kernel
    or the kernel and the slice reduce; counted in corr_core.launches
    (float32 S) or corr_core.bf16_launches (bf16 S)."""
    if s_flat.dim() != 3:
        raise ValueError(f"s_flat must be [B, N, D], got {tuple(s_flat.shape)}")
    b, n, d = s_flat.shape
    k = g_mat.shape[1] if g_mat.dim() == 3 else -1
    if not 1 <= k <= MAX_BINS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_BINS} bins, got K={k}")
    dev = s_flat.device
    _check("s_flat", s_flat, (b, n, d), dev, (torch.float32, torch.bfloat16))
    _check("g_mat", g_mat, (b, k, d), dev)
    _check("m_mat", m_mat, (k, d), dev)
    bf16 = s_flat.dtype == torch.bfloat16
    if round_sq and not bf16:
        raise ValueError("round_sq takes a bf16 S")
    s_type = S_BF16_ROUND_SQ if round_sq else S_BF16 if bf16 else S_F32
    lib = load_library()
    plan = corr_plan(b, n, d, k, _sm_count(dev.index), s_flat.element_size())
    out = torch.empty((b, n, k), device=dev, dtype=torch.float32)
    r = torch.empty_like(out) if need_r else out.new_empty((0,))
    part = (torch.empty(plan.slices * b * n * 2 * plan.kp, device=dev, dtype=torch.float32)
            if plan.slices > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccvpe_corr_fwd(s_flat.data_ptr(), g_mat.data_ptr(),
                                m_mat.data_ptr(), out.data_ptr(),
                                r.data_ptr() if need_r else None,
                                part.data_ptr() if part is not None else None,
                                b, n, d, k, plan.kp, plan.width, plan.slices,
                                plan.grid_x, s_type, stream)
    if rc != 0:
        raise RuntimeError(f"ccvpe_corr_fwd launch failed: CUDA error {rc}")
    if bf16:
        corr_core.bf16_launches += 1
    else:
        corr_core.launches += 1
    return out, r


def corr_core(s_flat: torch.Tensor, g_mat: torch.Tensor, m_mat: torch.Tensor,
              need_r: bool = False, round_sq: bool = False):
    """The op corr_fwd: the fused kernel on a CUDA tensor, its plain
    version on a CPU one. Same contract as corr_core_plain; S float32 or
    bf16 (round_sq only with bf16), G' and M float32, M exact in TF32 (0/1
    window masks are). Counts launches, float32 S in corr_core.launches and
    bf16 S in corr_core.bf16_launches."""
    out, r = corr_fwd(s_flat, g_mat, m_mat, need_r, round_sq)
    return (out, r) if need_r else out


corr_core.launches = 0
corr_core.bf16_launches = 0


def corr_core_bwd(grad_out: torch.Tensor, s_flat: torch.Tensor, g_mat: torch.Tensor,
                  m_mat: torch.Tensor, out: torch.Tensor, r: torch.Tensor):
    """Gradients of corr_core w.r.t. S and G' from the saved out and r (the
    port of ccvpe_tpu/ops/corr_pallas.py::_corr_core_bwd, :124-135; plain
    products there too), in G's dtype. d out / d S = r*G' - S * (out * r^2 * M)."""
    s_flat = s_flat.to(g_mat.dtype)
    a = grad_out * r                                   # [B,N,K]
    c = grad_out * out * (r * r)                       # [B,N,K]
    grad_s = torch.bmm(a, g_mat) - s_flat * torch.matmul(c, m_mat)
    grad_g = torch.bmm(a.transpose(1, 2), s_flat)
    return grad_s, grad_g


def _corr_fwd_setup(ctx, inputs, output):
    s_flat, g_mat, m_mat, need_r, _ = inputs
    out, r = output
    ctx.mark_non_differentiable(r)
    ctx.set_materialize_grads(False)
    ctx.need_r = need_r
    ctx.save_for_backward(s_flat, g_mat, m_mat, out, r)


def _corr_fwd_backward(ctx, grad_out, _grad_r):
    """corr_core_bwd from the saved out and r; the gradient of S in S's
    dtype."""
    if grad_out is None:
        return None, None, None, None, None
    if not ctx.need_r:
        raise RuntimeError("corr_fwd saves r only with need_r=True: differentiate "
                           "corr_core_diff, which sets it")
    s_flat, g_mat, m_mat, out, r = ctx.saved_tensors
    grad_s, grad_g = corr_core_bwd(grad_out, s_flat, g_mat, m_mat, out, r)
    return grad_s.to(s_flat.dtype), grad_g, None, None, None


corr_fwd.register_autograd(_corr_fwd_backward, setup_context=_corr_fwd_setup)


def corr_core_diff(s_flat: torch.Tensor, g_mat: torch.Tensor,
                   m_mat: torch.Tensor, round_sq: bool = False) -> torch.Tensor:
    """corr_core's out, with gradients to S and G' through the op's
    registered backward; the kernel writes r only where either needs one."""
    need_r = torch.is_grad_enabled() and (s_flat.requires_grad or g_mat.requires_grad)
    out = corr_core(s_flat, g_mat, m_mat, need_r=need_r, round_sq=round_sq)
    return out[0] if need_r else out


def rolled_corr_cuda(sat: torch.Tensor, grd: torch.Tensor, shift: int,
                     num_bins: int, center: bool = False,
                     bins: Optional[Sequence[int]] = None,
                     allow_bf16: bool = False) -> torch.Tensor:
    """ops.corr.rolled_corr through the fused kernel: sat [B,h,w,D] NHWC
    (a bf16 map stays bf16 and the kernel reads it), grd [B,L] ->
    [B,h,w,K]. Where ops/corr.py::bf16_rounding holds, G rounds to bf16
    before it is divided by the float32 norm of the unrounded G, and the
    kernel rounds S^2."""
    if bins is None:
        bins = tuple(range(num_bins))
    rnd = bf16_rounding(sat, allow_bf16)
    if sat.dtype != torch.bfloat16:
        sat = sat.float()
    grd = grd.float()
    b, h, w, d = sat.shape
    g_mat, m_mat = build_roll_matrices(round_bf16(grd) if rnd else grd, d, shift,
                                       tuple(bins), center)
    g_mat = g_mat / torch.linalg.vector_norm(grd, dim=-1)[:, None, None]
    # a view for channels_last activations, one copy otherwise
    s_flat = sat.reshape(b, h * w, d).contiguous()
    out = corr_core_diff(s_flat, g_mat.contiguous(), m_mat.contiguous(), rnd)
    return out.reshape(b, h, w, len(bins))
