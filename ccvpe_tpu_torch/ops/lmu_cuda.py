"""The fused LMU decoder stage on Hopper: the wrappers of csrc/lmu.cu, the
port of the Pallas kernels ccvpe_tpu/ops/lmu_pallas.py::_fused_stage_kernel
(:264, forward) and ::_fused_stage_bwd_kernel (:404, backward), and
`FusedStage`, the counterpart of the jax.custom_vjp fused_stage_diff
(:685-726): it saves only the inputs, and its backward is the backward
kernel, which recomputes h and g on chip.

`fused_stage` and `fused_stage_bwd` launch the kernels on CUDA tensors
(counting launches) and run the plain versions of ops/lmu.py on CPU
tensors. Shapes and layouts as in ops/lmu.py: NHWC float32 activations,
contiguous (the NHWC view of a channels_last NCHW tensor is), torch weight
layouts, which the wrappers turn into the kernel's. Nothing touches nvcc
or the card until a CUDA tensor arrives.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build csrc/lmu.cu for sm_90a at first use and bind its C entries."""
    from ccvpe_tpu_torch.csrc.build import build
    lib = ctypes.CDLL(str(build("lmu").path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccvpe_lmu_fwd.argtypes = [p] * 9 + [i] * 8 + [p]
    lib.ccvpe_lmu_fwd.restype = i
    lib.ccvpe_lmu_bwd_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 3
    lib.ccvpe_lmu_bwd_plan.restype = i
    lib.ccvpe_lmu_bwd.argtypes = [p] * 14 + [i] * 10 + [p]
    lib.ccvpe_lmu_bwd.restype = i
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


def kernel_weights(wd: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """torch layouts -> the kernel's operands (phase di*2+dj, tap ky*3+kx):
    wd [4][Cin][Cd], w1 [9][C][C1], w2 [9][C1][Cout] and, for the backward,
    the flipped-transposed w2T [9][Cout][C1] and w1T [9][C1][C] of the
    transposed convs and wdT [4][Cd][Cin] of dx (the TPU kernel's _flipT)."""
    wd, w1, w2 = wd.detach(), w1.detach(), w2.detach()
    cin, cd = wd.shape[:2]
    c1, c = w1.shape[:2]
    cout = w2.shape[0]
    return (wd.permute(2, 3, 0, 1).reshape(4, cin, cd).contiguous(),
            w1.permute(2, 3, 1, 0).reshape(9, c, c1).contiguous(),
            w2.permute(2, 3, 1, 0).reshape(9, c1, cout).contiguous(),
            w2.flip(2, 3).permute(2, 3, 0, 1).reshape(9, cout, c1).contiguous(),
            w1.flip(2, 3).permute(2, 3, 0, 1).reshape(9, c1, c).contiguous(),
            wd.permute(2, 3, 1, 0).reshape(4, cd, cin).contiguous())


def fused_stage(x: torch.Tensor, skip: Optional[torch.Tensor], wd: torch.Tensor,
                bd: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on a CUDA tensor, fused_stage_plain on a CPU one: y NHWC
    [B, 2Hc, 2Wc, Cout] float32. Counts launches in fused_stage.launches."""
    if not x.is_cuda:
        return fused_stage_plain(x, skip, wd, bd, w1, b1, w2, b2)
    b, hc, wc, cin, cs, cd, c1, cout = _dims(x, skip, wd, w1, w2)
    dev = x.device
    for name, t in (("x", x), ("skip", skip), ("bd", bd), ("b1", b1), ("b2", b2)):
        if t is not None:
            _check(name, t, dev)
    wdk, w1k, w2k = kernel_weights(wd, w1, w2)[:3]
    for name, t in (("wd", wdk), ("w1", w1k), ("w2", w2k)):
        _check(name, t, dev)
    lib = load_library()
    y = torch.empty((b, 2 * hc, 2 * wc, cout), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccvpe_lmu_fwd(x.data_ptr(), _ptr(skip), wdk.data_ptr(), bd.data_ptr(),
                               w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(), b2.data_ptr(),
                               y.data_ptr(), b, hc, wc, cin, cs, cd, c1, cout, stream)
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
    b, hc, wc, cin, cs, cd, c1, cout = _dims(x, skip, wd, w1, w2)
    if tuple(dy.shape) != (b, 2 * hc, 2 * wc, cout):
        raise ValueError(f"dy has shape {tuple(dy.shape)}, expected {(b, 2 * hc, 2 * wc, cout)}")
    dev = x.device
    for name, t in (("x", x), ("skip", skip), ("dy", dy), ("bd", bd), ("b1", b1)):
        if t is not None:
            _check(name, t, dev)
    wdk, w1k, _, w2t, w1t, wdt = kernel_weights(wd, w1, w2)
    for name, t in (("wd", wdk), ("w1", w1k), ("w2t", w2t), ("w1t", w1t), ("wdt", wdt)):
        _check(name, t, dev)
    lib = load_library()
    t_ = ctypes.c_int(0)
    nblk = ctypes.c_int(0)
    psize = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.ccvpe_lmu_bwd_plan(b, hc, wc, cin, cs, cd, c1, cout, ctypes.byref(t_),
                                    ctypes.byref(nblk), ctypes.byref(psize))
        if rc != 0:
            raise RuntimeError(f"ccvpe_lmu_bwd_plan failed: CUDA error {rc}")
        dx = torch.empty_like(x)
        dskip = None if skip is None else torch.empty_like(skip)
        part = torch.zeros((nblk.value, psize.value), device=dev, dtype=torch.float32)
        sums = torch.empty(psize.value, device=dev, dtype=torch.float32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccvpe_lmu_bwd(x.data_ptr(), _ptr(skip), dy.data_ptr(), wdk.data_ptr(),
                               bd.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                               w1t.data_ptr(), wdt.data_ptr(), dx.data_ptr(), _ptr(dskip),
                               part.data_ptr(), sums.data_ptr(), b, hc, wc, cin, cs, cd, c1,
                               cout, t_.value, nblk.value, stream)
    if rc != 0:
        raise RuntimeError(f"ccvpe_lmu_bwd launch failed: CUDA error {rc}")
    fused_stage_bwd.launches += 1
    c = cd + cs
    dwd, dbd, dw1, db1, dw2, db2 = torch.split(
        sums, [4 * cin * cd, cd, 9 * c * c1, c1, 9 * c1 * cout, cout])
    return (dx, dskip,
            dwd.reshape(2, 2, cin, cd).permute(2, 3, 0, 1),
            dbd,
            dw1.reshape(3, 3, c, c1).permute(3, 2, 0, 1),
            db1,
            dw2.reshape(3, 3, c1, cout).permute(3, 2, 0, 1),
            db2)


fused_stage_bwd.launches = 0


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
