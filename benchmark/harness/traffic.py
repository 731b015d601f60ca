"""The general traffic generator: a mix's parameters (benchmark/traffic/
<mix>.json) and a configuration's sizes in, a pool of seeded batches out.

Every batch holds `batch` pairs: a uint8 ground image and aerial image of
the configuration's sizes, and for each pair the ground truth (row and
column offset of the camera from the aerial patch's centre, uniform in
+-`row_offset` x height and +-`col_offset` x width; the heading, uniform
in `angle_deg`). The pool holds `pool` batches, which a run cycles through.
The same seed gives the same pool; every seed gives the same sizes. The
images are drawn on `device` in one call each and brought to the host once,
pinned where the device is a card."""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from reference.seeds import derive


class Batch(NamedTuple):
    grd: torch.Tensor          # [B, Hg, Wg, 3] uint8
    sat: torch.Tensor          # [B, Hs, Ws, 3] uint8
    row_offset: torch.Tensor   # [B] float32, pixels
    col_offset: torch.Tensor   # [B] float32, pixels
    angle_deg: torch.Tensor    # [B] float32, [0, 360)


def pool(traffic: dict, model: dict, seed: int, device) -> List[Batch]:
    """The mix's pool of host batches for run `seed`."""
    n, b = traffic["pool"], traffic["batch"]
    hg, wg = model["grd_size"]
    hs, ws = model["sat_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "traffic"))
    grd = torch.randint(0, 256, (n, b, hg, wg, 3), generator=gen, device=device, dtype=torch.uint8)
    sat = torch.randint(0, 256, (n, b, hs, ws, 3), generator=gen, device=device, dtype=torch.uint8)
    u = torch.rand((3, n, b), generator=gen, device=device)
    lo, hi = traffic["angle_deg"]
    rows = (2 * u[0] - 1) * traffic["row_offset"] * hs
    cols = (2 * u[1] - 1) * traffic["col_offset"] * ws
    angle = lo + u[2] * (hi - lo)
    pin = torch.device(device).type == "cuda"
    host = [t.cpu().pin_memory() if pin else t.cpu() for t in (grd, sat, rows, cols, angle)]
    return [Batch(*(t[i] for t in host)) for i in range(n)]
