"""How `correct` is decided: what the timed path produced, held to the plain
reference (benchmark/reference/) on the same weights and inputs, which the
benchmark makes from the seed and hands to both. Each number has a limit
of its own (benchmark/limits/<cell>.json); `correct` holds where every
number is within its limit. PERF.md gives the readings each limit was set
from, and why these numbers.

Training: the first three steps of the one train step the window drives,
on three batches of different rows. Numbers: the first step's loss
(`loss1_rel`, relative gap); the first gradient's norm as Adam holds it
after one step (its first moment over 1 - beta1), by the worst leaf
(`grad_gap`: |norm of the program - norm of the reference| over the larger
of the reference's norm of that leaf and of the median leaf); each
parameter's change after three steps, by the median leaf (`change_median`,
the same gap), leaving out leaves whose first gradient in the reference is
under a thousandth of the median leaf's. The later steps' losses and the
worst leaf's change swing with round-off that Adam's first updates carry
(PERF.md); `train_detail` keeps them for the calibration.

Serving: every answer of the window (row, column, heading and peak
probability of each pair). Numbers, by the worst answer: the served peak
against the reference's probability at the served position (`prob_rel`,
which a wrong position fails too), and the served heading against the
reference's field there, in degrees (`angle_deg`)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from reference import cvm, train as rtrain

ROUND_OFF_LEAF = 1e-3      # a leaf's first gradient under this share of the median leaf's


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Iterable[str]) -> Dict[str, float]:
    """Each leaf's |prog - ref| over the larger of its reference norm and
    the median leaf's."""
    names = list(names)
    med = float(torch.tensor([ref[n] for n in names]).median())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def train_detail(prog: dict, ref: dict) -> dict:
    """What the train numbers are made of: each step's loss gap, and the
    worst leaves and the median leaf of both norms' gaps."""
    counted = moved(ref)
    out = {"loss_steps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])],
           "left_out": sorted(set(ref["grad_norms"]) - set(counted))}
    for key, names in (("grad_norms", ref["grad_norms"]), ("change_norms", counted)):
        gaps = leaf_gaps(prog[key], ref[key], names)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:4]
        out[key] = {"median_gap": float(torch.tensor(list(gaps.values())).median()),
                    "worst": [[n, gaps[n], prog[key][n], ref[key][n]] for n in worst]}
    return out


def moved(ref: dict) -> list:
    """The leaves whose change is compared: first gradient in the reference
    at least ROUND_OFF_LEAF of the median leaf's."""
    med = float(torch.tensor(list(ref["grad_norms"].values())).median())
    return [n for n, g in ref["grad_norms"].items() if g >= ROUND_OFF_LEAF * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {'losses': [3], 'grad_norms': {leaf: norm}, 'change_norms':
    {leaf: norm}} of the program and of the reference."""
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moved(ref))
    return {
        "loss1_rel": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "grad_gap": max(leaf_gaps(prog["grad_norms"], ref["grad_norms"],
                                  ref["grad_norms"]).values()),
        "change_median": float(torch.tensor(list(change.values())).median()),
    }


def reference_train(model: dict, train_cfg: dict, seed: int, batches: Sequence, device,
                    tf32: bool = False, half_batch: bool = False) -> dict:
    """The reference's first steps from the seed's weights and drop-connect
    stream on `batches` (host traffic.Batch)."""
    from reference.seeds import derive
    params = rtrain.make_params(model, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "dropconnect"))
    dev = [tuple(t.to(device) for t in b) for b in batches]
    with cvm.precision(tf32):
        return rtrain.train_steps(model, train_cfg, params, dev, gen, half_batch)


def serve_numbers(model: dict, params: dict, pool: Sequence,
                  answers: Dict[int, List[torch.Tensor]], device
                  ) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """answers: pool index -> the served [B, 4] (row, col, angle, peak) of
    each request of it. Returns the numbers of the worst answer and each
    request's numbers."""
    worst = {"prob_rel": 0.0, "angle_deg": 0.0}
    per_request: List[Dict[str, float]] = []
    for idx in sorted(answers):
        b = pool[idx]
        with torch.no_grad(), cvm.precision():
            out = cvm.forward(params, model, b.grd.to(device), b.sat.to(device))
        heat, ori = out.heatmap, out.ori
        arange = torch.arange(heat.shape[0], device=device)
        for served in answers[idx]:
            s = served.to(device=device, dtype=torch.float64)
            rows, cols = s[:, 0].long(), s[:, 1].long()
            p_ref = heat[arange, rows, cols].double()
            prob = (s[:, 3] - p_ref).abs() / p_ref
            d = (s[:, 2] - cvm.angle(ori[arange, rows, cols]).double()).abs() % 360.0
            ang = torch.minimum(d, 360.0 - d)
            req = {"prob_rel": float(prob.max()), "angle_deg": float(ang.max())}
            per_request.append(req)
            for k, v in req.items():
                worst[k] = max(worst[k], v)
        del out, heat, ori
    return worst, per_request


def reference_answers(model: dict, params: dict, pool: Sequence, device,
                      tf32: bool = False) -> Dict[int, List[torch.Tensor]]:
    """The reference put in the program's place (a control): each pool
    batch's answers from its own forward and decode."""
    out = {}
    for idx, b in enumerate(pool):
        with torch.no_grad(), cvm.precision(tf32):
            o = cvm.forward(params, model, b.grd.to(device), b.sat.to(device))
            rows, cols, ang = cvm.decode(o.heatmap, o.ori)
            peak = o.heatmap.flatten(1).amax(dim=1)
        out[idx] = [torch.stack([rows.double(), cols.double(), ang.double(),
                                 peak.double()], dim=1).cpu()]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(numbers[k] <= limits[k] for k in limits)


def compared(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
