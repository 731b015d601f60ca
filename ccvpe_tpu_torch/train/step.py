"""Train and eval steps (the port of ccvpe_tpu/train/step.py:28-249,
268-288).

The train step replaces the reference's epoch-loop body (reference
train_VIGOR.py:112-150): GT rendered on the device from three scalars per
sample, the forward in train mode, the loss
CE + w_nce * mean(infoNCE over scales) + w_ori * ori (train_VIGOR.py:146),
backward and one optimizer update, with optional gradient accumulation
over sequential microbatches.

Where the JAX package is functional (a TrainState of pytrees, a jitted
step returning the new state), the port keeps the parameters and the BN
running stats in the CVM module and the moments in the optimizer: the step
updates `TrainState` in place and returns it. State lives on the card
unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ccvpe_tpu_torch.core.config import ModelConfig, TrainConfig
from ccvpe_tpu_torch.core.precision import float32_matmuls
from ccvpe_tpu_torch.models.cvm import CVM, CVMOutput, build_cvm, resolve_device
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.ops.gt import gaussian_heatmap, maxpool_pyramid, orientation_bin_weights
from ccvpe_tpu_torch.train.losses import cross_entropy_loss, infonce_loss, orientation_loss

# ImageNet normalization constants (ccvpe_tpu/data/transforms.py)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class Batch(NamedTuple):
    """One training batch: images NHWC, float32 (ImageNet-normalized on the
    host) or uint8 (normalized on the device); per-sample scalars for the GT."""
    grd: torch.Tensor          # [B, Hg, Wg, 3]
    sat: torch.Tensor          # [B, Hs, Ws, 3]
    row_offset: torch.Tensor   # [B]
    col_offset: torch.Tensor   # [B]
    angle_deg: torch.Tensor    # [B] in [0, 360)


def device_normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32; float32 passes through
    (already normalized on the host)."""
    if img.dtype != torch.uint8:
        return img
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img.float() / 255.0 - mean) / std


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total, end 0):
    linear from 0 over `warmup_steps`, then a half cosine to 0 at
    `total_steps`, 0 after."""
    def lr(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        decay = max(total_steps - warmup_steps, 1)
        frac = min(count - warmup_steps, decay) / decay
        return peak * 0.5 * (1.0 + math.cos(math.pi * frac))
    return lr


class Optimizer:
    """make_optimizer's counterpart of the optax chain: optional clipping
    by global norm, then Adam or AdamW, at a constant or warmup-cosine
    learning rate evaluated at the count of earlier updates (optax's)."""

    def __init__(self, params, train_cfg: TrainConfig):
        params = list(params)
        if train_cfg.optimizer not in ("adam", "adamw"):
            raise ValueError(f"optimizer must be 'adam' or 'adamw', got {train_cfg.optimizer!r}")
        if train_cfg.schedule not in ("constant", "warmup_cosine"):
            raise ValueError(f"schedule must be 'constant' or 'warmup_cosine', "
                             f"got {train_cfg.schedule!r}")
        if train_cfg.schedule == "warmup_cosine" and not train_cfg.total_steps:
            raise ValueError("warmup_cosine needs total_steps")
        self.params = params
        self.clip = train_cfg.grad_clip_norm
        self.schedule = (warmup_cosine(train_cfg.learning_rate, train_cfg.warmup_steps,
                                       train_cfg.total_steps)
                         if train_cfg.schedule == "warmup_cosine" else None)
        betas = (train_cfg.beta1, train_cfg.beta2)
        lr = self.schedule(0) if self.schedule else train_cfg.learning_rate
        if train_cfg.optimizer == "adamw":
            # optax.adamw decays every parameter by lr * wd * param
            self.opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                         weight_decay=train_cfg.weight_decay)
        else:
            self.opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
        self.count = 0

    def clip_(self) -> None:
        """optax.clip_by_global_norm: g * max_norm / ||g|| where ||g|| >= max_norm
        (no +1e-6 in the denominator, unlike clip_grad_norm_)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        torch._foreach_mul_(grads, scale)

    def step(self) -> None:
        """One update from the parameters' .grad."""
        if self.clip:
            self.clip_()
        self.opt.step()
        self.count += 1
        if self.schedule:
            for group in self.opt.param_groups:
                group["lr"] = self.schedule(self.count)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)


def make_optimizer(params, train_cfg: TrainConfig) -> Optimizer:
    """Reference default: plain Adam(1e-4, 0.9, 0.999) (train_VIGOR.py:104);
    optional warmup-cosine, AdamW decay, clipping. `flatten_optimizer`
    changes no numbers and is ignored."""
    return Optimizer(params, train_cfg)


@dataclasses.dataclass
class TrainState:
    step: int
    model: CVM                 # parameters and BN running stats, train mode
    optimizer: Optimizer


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None, device=None,
                       state_dict=None) -> TrainState:
    """A CVM in train mode with weights from `state_dict` (strict) or drawn
    from `generator`, and its optimizer, on `device` (default the card)."""
    model = build_cvm(model_cfg, resolve_device(device), state_dict, generator).train()
    return TrainState(0, model, make_optimizer(model.parameters(), train_cfg))


def _reversed_bins(model_cfg: ModelConfig) -> bool:
    # VIGOR and KITTI count bins in reversed order, Oxford forward
    return model_cfg.name != "oxford"


def compute_losses(model_cfg: ModelConfig, train_cfg: TrainConfig, out: CVMOutput,
                   batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The combined loss and its parts from the forward's outputs."""
    hs, ws = batch.sat.shape[1:3]
    gt = gaussian_heatmap(hs, ws, batch.row_offset, batch.col_offset)
    bin_w = orientation_bin_weights(batch.angle_deg, model_cfg.num_bins,
                                    _reversed_bins(model_cfg))              # [B, K]
    rad = batch.angle_deg.float() * (math.pi / 180.0)
    gt_ori = torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)[:, None, None, :]

    b = gt.shape[0]
    gt_flat = gt.reshape(b, -1)
    gt_flat = gt_flat / gt_flat.sum(dim=1, keepdim=True)
    loss_ce = cross_entropy_loss(out.logits, gt_flat)
    loss_ori = orientation_loss(out.ori, gt_ori.expand(*gt.shape[:3], 2), gt)

    nce_terms = []
    for s in out.matching_scores:
        factor = hs // s.shape[1]
        # maxpool(gaussian * w_k) = w_k * maxpool(gaussian) for w_k >= 0
        (gt_pool,) = maxpool_pyramid(gt, (factor,))           # [B, h, w, 1]
        gt_s = gt_pool * bin_w[:, None, None, :]              # [B, h, w, K]
        nce_terms.append(infonce_loss(
            s.reshape(b, -1), gt_s.reshape(b, -1), train_cfg.temperature,
            global_negatives=train_cfg.infonce_global_negatives))
    loss_nce = sum(nce_terms) / len(nce_terms)

    total = (loss_ce + train_cfg.weight_infonce * loss_nce
             + train_cfg.weight_ori * loss_ori)
    metrics = {"loss": total, "loss_ce": loss_ce, "loss_infonce": loss_nce,
               "loss_ori": loss_ori}
    return total, metrics


def make_loss_fn(model: CVM, model_cfg: ModelConfig, train_cfg: TrainConfig):
    """(batch, generator) -> (total, metrics): the train-mode forward (BN on
    batch statistics, running stats updated) and compute_losses."""
    def loss_fn(batch: Batch, generator: Optional[torch.Generator]):
        out = model(device_normalize(batch.grd), device_normalize(batch.sat), generator)
        return compute_losses(model_cfg, train_cfg, out, batch)
    return loss_fn


def to_batch(batch, device) -> Batch:
    """A Batch of numpy arrays or tensors -> tensors on `device`."""
    return Batch(*(torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   device=device) for v in batch))


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """(state, batch, generator) -> (state, metrics). One optimizer update
    per call; with train_cfg.grad_accum_steps = A > 1 the batch runs as A
    sequential microbatches, each backward adding grad / A, and the BN
    running stats pass from one microbatch to the next. `generator` (on the
    model's device) draws the drop-connect masks; metrics are 0-d tensors
    on the device (averaged over microbatches). Forward, backward and the
    update run in float32, TF32 off (core/precision.py)."""
    accum = train_cfg.grad_accum_steps
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")

    @float32_matmuls()
    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        model = state.model
        model.train()
        device = next(model.parameters()).device
        batch = to_batch(batch, device)
        b = batch.grd.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} does not split into {accum} microbatches")
        loss_fn = make_loss_fn(model, model_cfg, train_cfg)
        state.optimizer.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        m = b // accum
        for i in range(accum):
            mb = Batch(*(v[i * m:(i + 1) * m] for v in batch))
            total, metrics = loss_fn(mb, generator)
            (total / accum if accum > 1 else total).backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        state.optimizer.step()
        state.step += 1
        return state, {k: v / accum for k, v in sums.items()}

    return step


def make_eval_decode_step(model: CVM) -> Callable[..., Tuple[torch.Tensor, ...]]:
    """Forward + pose decode + GT location + prob@GT, returning six [B]
    tensors (pred rows, cols, angle deg, GT rows, cols, prob@GT) on the
    model's device; the heatmap never leaves it. Inputs are NHWC tensors on
    that device, images uint8 or normalized f32, offsets [B]. Runs in
    float32, TF32 off (core/precision.py)."""

    @torch.inference_mode()
    @float32_matmuls()
    def step(grd, sat, row_offset, col_offset):
        out = model(device_normalize(grd), device_normalize(sat))
        rows, cols, angle = pose.decode_pose(out.heatmap, out.ori)
        hs, ws = out.heatmap.shape[1:3]
        gt_rows, gt_cols = pose.gt_location_device(hs, ws, row_offset, col_offset)
        b = out.heatmap.shape[0]
        idx = torch.arange(b, device=out.heatmap.device)
        prob_gt = out.heatmap[idx, gt_rows, gt_cols, 0]
        return rows, cols, angle, gt_rows, gt_cols, prob_gt

    return step
