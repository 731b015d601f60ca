"""TF32 rounding and the 3xTF32 product in plain PyTorch: the arithmetic of
csrc/lmu.cu::mma_3xtf32, the tensor-core primitive of the fused stage
backward's weight gradients.

TF32 keeps float32's sign and 8-bit exponent and the top 10 of its 23
mantissa bits. `round_tf32` rounds to the nearest such value with ties away
from zero, as PTX's `cvt.rna.tf32.f32` does, and returns it as a float32
whose low 13 mantissa bits are zero. A float32 `a` splits into
`hi = round_tf32(a)` and `lo = round_tf32(a - hi)`, with `hi + lo` equal to
`a` within 2^-21 of |a|; a product of two TF32 values is exact in float32,
so `lo*hi' + hi*lo' + hi*hi'` summed in float32 is float32-accurate (the
dropped `lo*lo'` is ~2^-22 of |a a'|).
"""

from __future__ import annotations

from typing import Tuple

import torch

_LOW = (1 << 13) - 1          # the 13 mantissa bits that TF32 drops
_HALF = 1 << 12               # half a TF32 unit in the last place


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """a (float32) rounded to TF32, nearest with ties away from zero, on the
    int32 bits: adding half a unit to the magnitude bits and clearing the
    low 13 rounds a tie up in magnitude for either sign. Inf and NaN pass."""
    if a.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {a.dtype}")
    bits = a.contiguous().view(torch.int32)
    rounded = ((bits + _HALF) & ~_LOW).view(torch.float32)
    return torch.where(torch.isfinite(a), rounded, a)


def split_tf32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = round_tf32(a), lo = round_tf32(a - hi)."""
    hi = round_tf32(a)
    return hi, round_tf32(a - hi)


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] as mma_3xtf32 computes it: the small products
    lo*hi' + hi*lo' first, then hi*hi', each product exact, sums in float32
    (in the matmul's own order, not the tensor cores')."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
