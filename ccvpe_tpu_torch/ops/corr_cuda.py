"""Fused rolled correlation on Hopper: the wrapper of csrc/corr.cu, the port
of the Pallas kernel ccvpe_tpu/ops/corr_pallas.py::_corr_kernel (launched
by _corr_fwd_pallas, :70-110).

With the ground norm folded into the descriptor matrix (G' = G / ||g||),
the kernel computes per sat pixel t and bin k

    num[t,k]  = sum_d S[t,d] * G'[k,d]
    den2[t,k] = sum_d S[t,d]^2 * M[k,d]
    out[t,k]  = num * rsqrt(den2)        (and r = rsqrt(den2) if asked)

reading S once. The CUDA route is a plain C interface built with nvcc
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
import functools
from typing import Optional, Sequence, Tuple

import torch

from ccvpe_tpu_torch.ops.corr import build_roll_matrices

MAX_BINS = 32   # csrc/corr.cu kMaxBins


def corr_core_plain(s_flat: torch.Tensor, g_mat: torch.Tensor,
                    m_mat: torch.Tensor, need_r: bool = False):
    """Plain torch version of the kernel: s_flat [B,N,D], g_mat [B,K,D]
    (already / ||g||), m_mat [K,D] -> out [B,N,K] (and r [B,N,K])."""
    num = torch.bmm(s_flat, g_mat.transpose(1, 2))
    den2 = torch.matmul(s_flat * s_flat, m_mat.t())
    r = torch.rsqrt(den2)
    out = num * r
    return (out, r) if need_r else out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build csrc/corr.cu for sm_90a at first use and bind its C entry."""
    from ccvpe_tpu_torch.csrc.build import build
    lib = ctypes.CDLL(str(build("corr").path))
    lib.ccvpe_corr_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.ccvpe_corr_fwd.restype = ctypes.c_int
    return lib


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
    Same contract as corr_core_plain. Counts launches in corr_core.launches."""
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
    out = torch.empty((b, n, k), device=dev, dtype=torch.float32)
    r = torch.empty_like(out) if need_r else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccvpe_corr_fwd(s_flat.data_ptr(), g_mat.data_ptr(),
                                m_mat.data_ptr(), out.data_ptr(),
                                r.data_ptr() if need_r else None,
                                b, n, d, k, stream)
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
