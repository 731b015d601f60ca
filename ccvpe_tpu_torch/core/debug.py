"""Debug and determinism modes (the port of ccvpe_tpu/core/debug.py;
SURVEY.md 5: NaN checking and bitwise-deterministic execution flags).

NaN checks are autograd's anomaly mode with its NaN check: every backward
function's outputs are checked, and the error names the forward op that
made the NaN, with its traceback. Unlike jax_debug_nans it does not check
forward outputs, and it slows every backward.

Deterministic mode asks every op for its deterministic algorithm
(torch.use_deterministic_algorithms, which raises for an op that has none on
CUDA) and pins cuDNN to deterministic kernels without autotuning. cuBLAS is
deterministic only with a fixed workspace: CUBLAS_WORKSPACE_CONFIG=:4096:8
(or :16:8) must be in the environment before the process's first cuBLAS
call, so set it when the process starts, not here.
"""

from __future__ import annotations

import contextlib

import torch


def enable_nan_checks() -> None:
    """Raise where a backward function returns a NaN."""
    torch.autograd.set_detect_anomaly(True, check_nan=True)


def disable_nan_checks() -> None:
    torch.autograd.set_detect_anomaly(False)


@contextlib.contextmanager
def nan_checks():
    """NaN checks for the block; the caller's anomaly flags after it."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


def enable_deterministic() -> None:
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def deterministic():
    """Deterministic mode for the block; the caller's flags after it."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    enable_deterministic()
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]
