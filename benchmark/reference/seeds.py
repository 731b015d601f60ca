"""Seeds of the generators a run draws from, each derived from the run's
`--seed` and a name, so that the weights, the inputs and drop-connect
draw from separate streams. Any whole number, of any size, is a seed."""

from __future__ import annotations

import hashlib


def derive(seed: int, name: str) -> int:
    """A 63-bit seed for the stream `name` of run `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
