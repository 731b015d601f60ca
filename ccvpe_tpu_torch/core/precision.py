"""The port computes in float32, as the JAX package does.

torch's default lets cuDNN run float32 convolutions in TF32 (a 10-bit
mantissa), and a caller may have switched TF32 on for cuBLAS too. The entry
points (`InferenceEngine._run`, the steps that `make_train_step` and
`make_eval_decode_step` return) run under `float32_matmuls`, which switches
both off and gives the caller's settings back on exit. There is no TF32
option: the JAX package has no TF32 mode.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def float32_matmuls() -> Iterator[None]:
    """TF32 off in cuBLAS matmuls and cuDNN convolutions inside the block,
    the caller's flags restored after it. The flags are process-wide, so
    the autograd engine's device threads see them too during a backward
    started inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
