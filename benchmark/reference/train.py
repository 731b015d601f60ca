"""CCVPE's training objective and Adam in plain float32 PyTorch (the
reference implementation's train_VIGOR.py:112-150 and losses.py:4-29):
the ground truth rendered from (row offset, col offset, heading), the
soft-label cross-entropy on the localization heatmap, infoNCE on every
scale's matching scores, the orientation loss, and Adam written out.

Imports torch, the standard library and the reference model only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from reference import cvm
from reference.seeds import derive

SIGMA = 4.0     # px, the GT Gaussian (datasets.py:149)


def gaussian(h: int, w: int, row_off: torch.Tensor, col_off: torch.Tensor) -> torch.Tensor:
    """The GT heatmap [B, H, W]: a sigma-4 Gaussian around (centre -
    row_off, centre + col_off) on the inclusive-endpoint linspace grid."""
    xs = torch.linspace(-w / 2.0, w / 2.0, w, device=row_off.device)
    ys = torch.linspace(-h / 2.0, h / 2.0, h, device=row_off.device)
    x = xs[None, None, :] + col_off.float()[:, None, None]
    y = ys[None, :, None] - row_off.float()[:, None, None]
    return torch.exp(-(x * x + y * y) / (2.0 * SIGMA * SIGMA))


def bin_weights(angle_deg: torch.Tensor, k: int) -> torch.Tensor:
    """[B, K]: the heading split linearly over its two neighbouring bins,
    counted in VIGOR's and KITTI's reversed order (bin 0 and K-1 next to
    0 degrees, bin K-i and K-i-1 next to bin i)."""
    a = angle_deg.float()
    step = 360.0 / k
    i = torch.floor(a / step).long()
    ratio = torch.remainder(a, step) / step
    first = torch.where(i == 0, torch.zeros_like(i), k - i)
    second = torch.where(i == 0, torch.full_like(i, k - 1), k - i - 1)
    w = torch.zeros(a.shape[0], k, device=a.device)
    w.scatter_add_(1, first[:, None], (1.0 - ratio)[:, None])
    w.scatter_add_(1, second[:, None], ratio[:, None])
    return w


def losses(cfg: dict, weights: dict, out: cvm.Output, row_off: torch.Tensor,
           col_off: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """CE + w_infonce * mean over scales of infoNCE + w_ori * orientation."""
    b = out.logits.shape[0]
    hs, ws = out.heatmap.shape[1:]
    gt = gaussian(hs, ws, row_off, col_off)                        # [B, H, W]
    labels = gt.reshape(b, -1) / gt.reshape(b, -1).sum(dim=1, keepdim=True)
    ce = -(labels * torch.log_softmax(out.logits, dim=1)).sum() / b

    rad = angle_deg.float() * (math.pi / 180.0)
    gt_ori = torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)[:, None, None, :]
    ori = ((gt_ori - out.ori).square().sum(dim=-1) * gt).sum() / b

    w_bins = bin_weights(angle_deg, cfg["num_bins"])
    nce = []
    for s in out.scores:
        f = hs // s.shape[1]
        pooled = gt.reshape(b, hs // f, f, ws // f, f).amax(dim=(2, 4))
        lab = (pooled[..., None] * w_bins[:, None, None, :]).reshape(b, -1)
        logp = torch.log_softmax(s.reshape(b, -1) / weights["temperature"], dim=1)
        pos = torch.where(lab > 1e-2, lab, torch.zeros_like(lab))
        nce.append(-(pos * logp).sum() / pos.sum())
    return ce + weights["weight_infonce"] * (sum(nce) / len(nce)) + weights["weight_ori"] * ori


class Adam:
    """Adam (Kingma and Ba 2015) with bias correction, written out:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = list(params), lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def train_steps(cfg: dict, train_cfg: dict, params: Dict[str, torch.Tensor],
                batches: List[Tuple[torch.Tensor, ...]], gen: torch.Generator,
                half_batch: bool = False) -> dict:
    """Train `params` (float32 tensors, updated in place) on `batches` of
    (grd, sat, row_off, col_off, angle), one Adam step each. Returns each
    step's loss, each trained leaf's first-gradient norm, and each leaf's
    change after all the steps, by name. `half_batch` computes every loss
    on the first half of the rows alone: a planted fault for the check."""
    names = [n for n, t in params.items() if t.is_floating_point() and not _buffer(n)]
    for n in names:
        params[n].requires_grad_(True)
    start = {n: params[n].detach().clone() for n in names}
    opt = Adam([params[n] for n in names], train_cfg["learning_rate"], train_cfg["beta1"],
               train_cfg["beta2"])
    step_losses, grad_norms = [], None
    for grd, sat, row_off, col_off, ang in batches:
        if half_batch:
            h = grd.shape[0] // 2
            grd, sat, row_off, col_off, ang = grd[:h], sat[:h], row_off[:h], col_off[:h], ang[:h]
        out = cvm.forward(params, cfg, grd, sat, train=True, gen=gen)
        loss = losses(cfg, train_cfg, out, row_off, col_off, ang)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        if grad_norms is None:
            grad_norms = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(names, grads)}
        step_losses.append(float(loss.detach()))
        opt.step(grads)
        del out, loss, grads
    change = {n: float(torch.linalg.vector_norm(params[n].detach() - start[n])) for n in names}
    for n in names:
        params[n].requires_grad_(False)
    return {"losses": step_losses, "grad_norms": grad_norms, "change_norms": change}


def _buffer(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of `cfg` from `seed` on `device`: every weight from one
    normal draw of a generator on the device, scaled to std 1/sqrt(fan_in),
    biases 0, BatchNorm at identity (scale 1, shift 0, mean 0, variance 1)."""
    shapes = cvm.param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    weights = [(n, s) for n, (kind, s) in shapes.items() if kind == "w"]
    total = sum(math.prod(s) for _, s in weights)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n, s in weights:
        size = math.prod(s)
        out[n] = flat[at:at + size].view(s) * cvm.fan_in(n, s) ** -0.5
        at += size
    del flat
    fill = {"b": 0.0, "bn_w": 1.0, "bn_b": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    for n, (kind, s) in shapes.items():
        if kind == "bn_n":
            out[n] = torch.zeros((), dtype=torch.long, device=device)
        elif kind != "w":
            out[n] = torch.full(s, fill[kind], device=device)
    return {n: out[n] for n in shapes}
