"""The benchmark's own tests (benchmark/tests/): the benchmark's modules on
the path, and the `card` marker for tests that need a CUDA card, which skip
elsewhere from a fixture (never while a module is imported).

    python -m pytest benchmark/tests -q            # on the CPU
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
