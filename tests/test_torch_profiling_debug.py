"""The port's profiling and debug helpers (core/profiling.py, core/debug.py):
trace writing a Chrome trace, and deterministic() and nan_checks()
restoring the caller's flags. The spans, counts and marks of
core/profiling.py: tests/test_torch_tracing.py."""

import glob
import json
import os

import pytest
import torch

from ccvpe_tpu_torch.core import debug
from ccvpe_tpu_torch.core.profiling import trace


def test_trace_writes_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)


@pytest.mark.parametrize("caller", [(False, False, False, True), (True, True, False, False)])
def test_deterministic_restores_flags(caller):
    before = _flags()
    try:
        torch.use_deterministic_algorithms(caller[0], warn_only=caller[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = caller[2:]
        with debug.deterministic():
            assert _flags()[0] and not _flags()[1]
            assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert _flags() == caller
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:]


def test_nan_checks_raise_and_restore():
    assert not torch.is_anomaly_enabled()
    x = torch.tensor([-1.0], requires_grad=True)
    with debug.nan_checks():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    debug.enable_nan_checks()
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    finally:
        debug.disable_nan_checks()
    assert not torch.is_anomaly_enabled()
