"""Orientation-rolled descriptor correlation (the port of
ccvpe_tpu/ops/corr.py:36-176, 238-261).

Per orientation bin i and sat pixel, the reference scores

    window_i = roll(sat, -i*shift, channel)[off:off+L]
    score_i  = <grd, window_i> / (||window_i|| * ||grd||)

with window_i[c] = S[(off + c + i*shift) mod D]. Embedding the ground
descriptor at offset `off` in a length-D zero vector turns all bins into
two products against small [K, D] matrices of K rolls:

    num_i    = sum_d roll(g_pad, i*shift)[d] * S[d]
    den2_i   = sum_d roll(m_pad, i*shift)[d] * S[d]^2

`rolled_corr` is that plain formulation; ops/corr_cuda.py fuses both
products and the normalisation into one CUDA kernel.

A bfloat16 map (ModelConfig.compute_dtype) is scored as the JAX package
scores it on its TPU. At D >= BF16_ROUND_MAX_D its Pallas kernel upcasts
the map: the float32 cosine of the bf16 values. Below, its XLA path with
`allow_bf16` (ModelConfig.corr_bf16) rounds the ground descriptor and the
squared map to bf16 before their products; the ground norm stays the
float32 norm of the unrounded descriptor (`bf16_rounding`).

Shapes: sat [B, h, w, D] (NHWC), grd [B, L], output [B, h, w, K].
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ccvpe_tpu_torch.core.config import CORR_IMPLS

# the JAX package's TPU dispatch sends D >= 128 to its Pallas kernel
# (ccvpe_tpu/ops/corr.py:168), which ignores allow_bf16
BF16_ROUND_MAX_D = 128


def bf16_rounding(sat: torch.Tensor, allow_bf16: bool) -> bool:
    """Whether the correlation of `sat` rounds the ground descriptor and
    the squared map to bf16: allow_bf16, a bf16 map and D < 128."""
    return (allow_bf16 and sat.dtype == torch.bfloat16
            and sat.shape[-1] < BF16_ROUND_MAX_D)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _window_offset(total: int, length: int, center: bool) -> int:
    """Channel offset of the matching window in the rolled map: 0 in
    'first' mode, int(D/2 - L/2) in 'center' mode (reference models.py:1094,
    the float expression kept as it is)."""
    return int(total / 2 - length / 2) if center else 0


def build_roll_matrices(
    grd: torch.Tensor,
    total_dim: int,
    shift: int,
    bins: Sequence[int],
    center: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """G [B, K, D] (rolled zero-embedded descriptors) and M [K, D] (rolled
    window masks). Bins may be negative (orientation prior)."""
    b, length = grd.shape
    off = _window_offset(total_dim, length, center)
    g_pad = grd.new_zeros((b, total_dim))
    g_pad[:, off:off + length] = grd
    m_pad = grd.new_zeros((total_dim,))
    m_pad[off:off + length] = 1.0
    g_mat = torch.stack([torch.roll(g_pad, k * shift, dims=-1) for k in bins], dim=1)
    m_mat = torch.stack([torch.roll(m_pad, k * shift, dims=-1) for k in bins], dim=0)
    return g_mat, m_mat


def rolled_corr(
    sat: torch.Tensor,
    grd: torch.Tensor,
    shift: int,
    num_bins: int,
    center: bool = False,
    bins: Optional[Sequence[int]] = None,
    allow_bf16: bool = False,
) -> torch.Tensor:
    """Cosine matching scores for all orientation bins, plain torch (two
    einsums, f32; a bf16 map rounds as `bf16_rounding` says). Returns
    [B, h, w, K], K = len(bins) or num_bins."""
    if bins is None:
        bins = tuple(range(num_bins))
    rnd = bf16_rounding(sat, allow_bf16)
    sat = sat.float()
    grd = grd.float()
    g_norm = torch.linalg.vector_norm(grd, dim=-1)
    g_mat, m_mat = build_roll_matrices(round_bf16(grd) if rnd else grd, sat.shape[-1], shift,
                                       bins, center)
    num = torch.einsum("bhwd,bkd->bhwk", sat, g_mat)
    sq = sat * sat
    den_sq = torch.einsum("bhwd,kd->bhwk", round_bf16(sq) if rnd else sq, m_mat)
    return num / (torch.sqrt(den_sq) * g_norm[:, None, None, None])


def rolled_corr_dispatch(
    sat: torch.Tensor,
    grd: torch.Tensor,
    shift: int,
    num_bins: int,
    center: bool = False,
    bins: Optional[Sequence[int]] = None,
    impl: str = "auto",
    allow_bf16: bool = False,
) -> torch.Tensor:
    """Route by `impl` and the tensor's device: 'auto' takes the CUDA kernel
    for a CUDA tensor and the plain version for a CPU tensor, at every D
    and for a float32 or bf16 map; 'plain' always the plain version; 'cuda'
    the kernel, raising on a CPU tensor. `allow_bf16`: ModelConfig.corr_bf16."""
    if impl not in CORR_IMPLS:
        raise ValueError(f"corr_impl must be one of {CORR_IMPLS}, got {impl!r}")
    if impl == "cuda" and not sat.is_cuda:
        raise ValueError("corr_impl='cuda' needs a CUDA tensor; got one on "
                         f"{sat.device}")
    if impl == "plain" or (impl == "auto" and not sat.is_cuda):
        return rolled_corr(sat, grd, shift, num_bins, center, bins, allow_bf16)
    from ccvpe_tpu_torch.ops.corr_cuda import rolled_corr_cuda
    return rolled_corr_cuda(sat, grd, shift, num_bins, center, bins, allow_bf16)


def rolled_corr_reference(
    sat: torch.Tensor,
    grd: torch.Tensor,
    shift: int,
    num_bins: int,
    center: bool = False,
    bins: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Direct transcription of the reference loop (roll + slice + norms),
    used only to test the matmul formulation. [B, h, w, K]."""
    if bins is None:
        bins = tuple(range(num_bins))
    d = sat.shape[-1]
    length = grd.shape[-1]
    off = _window_offset(d, length, center)
    g_norm = torch.linalg.vector_norm(grd, dim=-1)[:, None, None]
    out = []
    for k in bins:
        window = torch.roll(sat, -k * shift, dims=-1)[..., off:off + length]
        den = torch.linalg.vector_norm(window, dim=-1) * g_norm
        num = torch.einsum("bhwc,bc->bhw", window, grd)
        out.append(num / den)
    return torch.stack(out, dim=-1)
