"""Fixed test orientations for the VIGOR "unknown orientation" evaluation
(the port of ccvpe_tpu/data/fixtures.py).

The reference ships samearea/crossarea_orientation_test.npy (52,605 /
53,694 float64 angles in degrees) and indexes them per test sample, so the
random-orientation evaluation is reproducible (reference
train_VIGOR.py:73-79, datasets.py:109-116). The port carries its own copy of
the JAX package's float32 re-encoding (max round-trip error 1.6e-5 degrees)
in ccvpe_tpu_torch/assets/orientation_test.npz; where $CCVPE_REFERENCE names
a directory holding the reference's .npy files, their float64 originals are
read instead.
"""

from __future__ import annotations

import os

import numpy as np

_ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "assets", "orientation_test.npz")

_EXPECTED_LEN = {"samearea": 52605, "crossarea": 53694}


def load_orientation_fixture(area: str) -> np.ndarray:
    """Fixed test orientations (degrees) for `area` in {samearea, crossarea}.
    Raises FileNotFoundError where neither the reference mount nor the asset
    exists: the evaluation never falls back to fresh random orientations."""
    if area not in _EXPECTED_LEN:
        raise ValueError(f"unknown area {area!r}")
    mount = os.environ.get("CCVPE_REFERENCE")
    ref = os.path.join(mount, f"{area}_orientation_test.npy") if mount else None
    if ref and os.path.exists(ref):
        return np.load(ref)
    if os.path.exists(_ASSET):
        with np.load(_ASSET) as z:
            return np.asarray(z[area], np.float64)
    raise FileNotFoundError(
        f"orientation fixture for {area!r} not found: neither "
        f"$CCVPE_REFERENCE/{area}_orientation_test.npy nor {_ASSET} exists; "
        "the unknown-orientation evaluation is not reproducible without it")
