"""Train and eval steps (the port of ccvpe_tpu/train/step.py:28-288).

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

Across processes (core/mesh.py; one card each) the step is the JAX step
on the global batch, each data index holding its block of rows (the model
ranks of one data index the same rows): BatchNorm's moments and the
losses are the global batch's (nn/efficientnet.py, train/losses.py), each
process backpropagates that loss, and the gradients are averaged over
every process in one flat float32 all-reduce (the partial gradients of
the parameters run on row blocks under ModelConfig.spatial_axis weighted
by the model size; core/mesh.py's note says why) before clipping and the
update, so every process applies the same update. With gradient accumulation microbatch i is the global rows
[i*M, (i+1)*M) of the global batch, M = D * B / A, as the JAX package's
reshape slices it: every process gathers the data group's inputs and runs
its B / A rows of each.

The eval steps (make_eval_step, make_eval_decode_step) are, as the JAX
package's jitted ones, one compiled executable per input shape: one CUDA
graph on the card (EvalStep, core/graphs.py::GraphCache).

Traced (core/profiling.py), a train step is the span `train.step`
holding `train.stage` (the batch copied into the graph's inputs),
`train.replay`, `train.rebind` (the gradients set on the parameters),
`train.metrics` (the clones), or `train.eager`; the process counts
`train.steps`. On the card the marks `encoders` (in the model),
`backward` and `optimizer` bound those layers inside the replay; the eval
steps' graphs carry the model's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.core.config import ModelConfig, TrainConfig
from ccvpe_tpu_torch.core.graphs import Graph, GraphCache
from ccvpe_tpu_torch.core.precision import float32_matmuls
from ccvpe_tpu_torch.core.profiling import count, marked, marking, span
from ccvpe_tpu_torch.models.cvm import CVM, CVMOutput, build_cvm, resolve_device
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.ops.gt import (gaussian_heatmap, gaussian_heatmap_window, maxpool_pyramid,
                                    orientation_bin_weights)
from ccvpe_tpu_torch.train.losses import cross_entropy_loss, infonce_loss, orientation_loss

# Optimizer.serial: a new number for each optimizer and each restore
_SERIALS = itertools.count()

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
    return (img.float() / 255.0 - _filled(_IMAGENET_MEAN, img.device)) / _filled(
        _IMAGENET_STD, img.device)


def _filled(values, device) -> torch.Tensor:
    """values as a float32 vector filled on `device` (torch.tensor's
    values): a CUDA graph capture may not copy from pageable host memory."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in values])


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
    learning rate evaluated at the count of earlier updates (optax's).

    On the card the torch optimizer is capturable (its step counts and
    bias corrections stay on the card) and its learning rate is a tensor
    the schedule fills in place, so one CUDA graph holds the whole update
    and reads the rate of each step (train/step.py::make_train_step). Eager
    steps on the card take the same path, so eager and graphed steps give
    the same bits. On the CPU it is the plain optimizer with a float rate.

    `serial` names the tensors it holds: a new number for each optimizer
    and after each load_state_dict, which replaces them. A captured step is
    bound to it (state_binding)."""

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
        self.capturable = bool(params) and params[0].is_cuda
        if self.capturable:
            lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
        kw = dict(lr=lr, betas=betas, eps=1e-8, capturable=self.capturable)
        if train_cfg.optimizer == "adamw":
            # optax.adamw decays every parameter by lr * wd * param
            self.opt = torch.optim.AdamW(params, weight_decay=train_cfg.weight_decay, **kw)
        else:
            self.opt = torch.optim.Adam(params, **kw)
        self.count = 0
        self.serial = next(_SERIALS)

    def clip_(self) -> None:
        """optax.clip_by_global_norm: g * max_norm / ||g|| where ||g|| >= max_norm
        (no +1e-6 in the denominator, unlike clip_grad_norm_)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        torch._foreach_mul_(grads, scale)

    def update(self) -> None:
        """The device work of one update from the parameters' .grad:
        clipping and the torch optimizer's step (what a CUDA graph holds)."""
        if self.clip:
            self.clip_()
        self.opt.step()

    def advance(self) -> None:
        """The host's part of an update: the count, and the schedule's rate
        for the next one (a tensor rate is filled in place)."""
        self.count += 1
        if self.schedule:
            lr = self.schedule(self.count)
            for group in self.opt.param_groups:
                if torch.is_tensor(group["lr"]):
                    group["lr"].fill_(lr)
                else:
                    group["lr"] = lr

    def step(self) -> None:
        """One update from the parameters' .grad."""
        self.update()
        self.advance()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The torch optimizer's state_dict with a float learning rate, so a
        checkpoint restores on the card and on the CPU alike."""
        sd = self.opt.state_dict()
        sd["param_groups"] = [dict(g, lr=float(g["lr"])) for g in sd["param_groups"]]
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore a state_dict of either form (float or tensor rate, saved
        capturable or not) into this optimizer's own form: its capturable
        flag (which puts Adam's step counts on the card or the host), and
        its own rate tensor filled with the saved rate."""
        own = self.opt.param_groups
        groups = [dict(g, lr=float(g["lr"]), capturable=o["capturable"])
                  for g, o in zip(sd["param_groups"], own)]
        rates = [o["lr"] for o in own]
        self.opt.load_state_dict(dict(sd, param_groups=groups))
        self.serial = next(_SERIALS)
        for group, rate in zip(self.opt.param_groups, rates):
            if torch.is_tensor(rate):
                rate.fill_(group["lr"])
                group["lr"] = rate


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
    if out.ori_offsets is not None:
        # the windowed ori field (ModelConfig.ori_window) against the same
        # Gaussian restricted to the window: exactly 0 outside it, so the
        # weighted sum is the full field's
        win = out.ori.shape[1]
        gt_win = gaussian_heatmap_window(hs, ws, win, out.ori_offsets[:, 0],
                                         out.ori_offsets[:, 1], batch.row_offset,
                                         batch.col_offset)
        loss_ori = orientation_loss(out.ori, gt_ori.expand(b, win, win, 2), gt_win)
    else:
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


def ori_window_starts(model_cfg: ModelConfig, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample fine-resolution origin of the ori window: the GT pixel
    (the Gaussian's argmax on ops/gt.py's inclusive-linspace grid) centred
    in a ModelConfig.ori_window box, clamped to the image and snapped down
    to a multiple of 4, so the crop at 1/4 resolution starts on a pixel.
    Returns (r0, c0), [B] int64."""
    h, w = model_cfg.sat_size
    win = model_cfg.ori_window
    i_star = (batch.row_offset.float() + h / 2.0) * (h - 1) / h
    j_star = (-batch.col_offset.float() + w / 2.0) * (w - 1) / w
    r0 = torch.clamp(torch.round(i_star - win / 2.0), 0, h - win).long()
    c0 = torch.clamp(torch.round(j_star - win / 2.0), 0, w - win).long()
    return r0 // 4 * 4, c0 // 4 * 4


def make_loss_fn(model: CVM, model_cfg: ModelConfig, train_cfg: TrainConfig):
    """(batch, generator) -> (total, metrics): the train-mode forward (BN on
    batch statistics, running stats updated), with the ori window around
    the GT when ModelConfig.ori_window is set, and compute_losses."""
    def loss_fn(batch: Batch, generator: Optional[torch.Generator]):
        window = ori_window_starts(model_cfg, batch) if model_cfg.ori_window else None
        out = model(device_normalize(batch.grd), device_normalize(batch.sat), generator,
                    window)
        return compute_losses(model_cfg, train_cfg, out, batch)
    return loss_fn


def to_batch(batch, device) -> Batch:
    """A Batch of numpy arrays or tensors -> tensors on `device`."""
    return Batch(*(torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   device=device) for v in batch))


def state_binding(state: TrainState, generator: Optional[torch.Generator]) -> Tuple:
    """What a captured step is bound to: the state's model, its optimizer's
    serial and the generator it draws from. Another state, a new optimizer
    or one whose tensors the port replaced (Optimizer.load_state_dict, which
    a checkpoint restore calls) gives another binding, and the step
    captures again. A model load_state_dict copies into the same tensors
    and keeps the binding, as the graph stays right. Tensors replaced
    behind the port's back (assigning a parameter's .data, moving the
    model) are not seen: give the step a new state. A few ids, not a walk
    over the ~2.4k tensors of vigor()'s state, since it runs before every
    replay."""
    return (id(state.model), state.optimizer.serial, id(generator))


class _StepGraph:
    """One batch shape's captured step: its static inputs, the graph, the
    static metrics and the gradients the graph writes; it holds the
    generator, whose id is in the binding, so that no other takes that id
    while the graph lives."""

    def __init__(self, binding, inputs: Batch, graph: Graph, metrics, grads, generator):
        self.binding, self.inputs, self.graph = binding, inputs, graph
        self.metrics, self.grads, self.generator = metrics, grads, generator


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig, cuda_graph: bool = True):
    """(state, batch, generator) -> (state, metrics). One optimizer update
    per call; with train_cfg.grad_accum_steps = A > 1 the batch runs as A
    sequential microbatches, each backward adding grad / A, and the BN
    running stats pass from one microbatch to the next. `generator` (on the
    model's device) draws the drop-connect masks; metrics are 0-d tensors
    on the device (averaged over microbatches). Forward, backward and the
    update run in float32, TF32 off (core/precision.py).

    On the card, with `cuda_graph` (the counterpart of the JAX step's one
    jitted executable), the whole step (zeroed grads, forwards and losses,
    backwards, clipping and the optimizer's update) is one CUDA graph per
    batch shape and dtype (core/graphs.py). The first call for a shape, and
    the first after the state's binding changed (state_binding: another
    state, restored optimizer tensors, another generator), runs eagerly: it
    allocates Adam's moments and builds the kernels. The next call with the
    same binding captures, then replays; later calls copy the batch into the
    graph's static inputs and replay. The generator is registered with the
    graph, so a seed set before a call gives the draws an eager call gives.
    Gradients live in the graph's memory pool and are set on the parameters
    after each replay; metrics come back as clones of its static outputs.
    `step.captures` counts captures. A capture that fails raises, as does a
    graphed call under NaN checks (anomaly mode cannot be captured: pass
    cuda_graph=False) or under a process group other than nccl's (gloo's
    collectives on the card cannot be captured: pass cuda_graph=False);
    nccl's collectives are captured with the step. The graph's private memory pool comes on top of the
    eager step's blocks: a stale graph's pool is given back before the
    eager step (torch.cuda.graph empties the cache before a capture), and a
    batch near the card's memory limit can take cuda_graph=False, which
    keeps the eager step's memory alone. On the CPU every step runs
    eagerly."""
    if train_cfg.grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {train_cfg.grad_accum_steps}")
    return TrainStep(model_cfg, train_cfg, cuda_graph)


class TrainStep:
    """The step make_train_step returns; `captures` counts its captures.
    A class, not a closure: a closure that counted on itself would be a
    reference cycle, and the graph's memory pool would outlive the step
    until the garbage collector ran."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, cuda_graph: bool):
        self.model_cfg, self.train_cfg, self.cuda_graph = model_cfg, train_cfg, cuda_graph
        self.accum = train_cfg.grad_accum_steps
        self.captures = 0
        self._graphs: Dict[Tuple, _StepGraph] = {}
        self._warmed: Dict[Tuple, Tuple] = {}    # batch key -> binding after its eager run

    def _run(self, state: TrainState, batch: Batch, generator: Optional[torch.Generator]):
        """The device work of one update; returns the averaged metrics."""
        accum, data = self.accum, mesh.data_size()
        loss_fn = make_loss_fn(state.model, self.model_cfg, self.train_cfg)
        state.optimizer.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        m = batch.grd.shape[0] // accum         # this process's rows of a microbatch
        if accum > 1 and data > 1:
            # global microbatch i holds data index d's rows from (i * D + d) * m
            batch = Batch(*(mesh.gather_rows(v) for v in batch))
            starts = [(i * data + mesh.data_index()) * m for i in range(accum)]
        else:
            starts = [i * m for i in range(accum)]
        with marking(batch.grd.device):
            for start in starts:
                mb = Batch(*(v[start:start + m] for v in batch))
                total, metrics = loss_fn(mb, generator)
                with marked("backward"):
                    (total / accum if accum > 1 else total).backward()
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v.detach()
            mesh.mean_grads(list(state.model.parameters()), state.model.row_block_params())
            with marked("optimizer"):
                state.optimizer.update()
        return {k: v / accum for k, v in sums.items()}

    def _graphed(self, state: TrainState, batch, generator) -> Dict[str, torch.Tensor]:
        if torch.is_anomaly_enabled():
            raise RuntimeError("NaN checks (autograd anomaly mode) cannot run inside a CUDA "
                               "graph: make the step with cuda_graph=False")
        if not mesh.capturable():
            raise RuntimeError(f"the collectives of a {mesh.backend()} process group cannot run "
                               "inside a CUDA graph: make the step with cuda_graph=False")
        src = [v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)) for v in batch]
        key = tuple((tuple(v.shape), v.dtype) for v in src)
        binding = state_binding(state, generator)
        entry = self._graphs.get(key)
        if entry is None or entry.binding != binding:
            device = next(state.model.parameters()).device
            if entry is not None:
                # a stale graph: its pool, and the gradients in it, go
                # before the eager step allocates anything
                del self._graphs[key], entry
                state.optimizer.zero_grad()
                torch.cuda.empty_cache()
            if self._warmed.get(key) != binding:
                count("graph.eager")
                with span("train.eager"):
                    metrics = self._run(state, to_batch(src, device), generator)
                self._warmed[key] = state_binding(state, generator)
                return metrics
            inputs = Batch(*(torch.empty(v.shape, dtype=v.dtype, device=device) for v in src))
            with span("train.stage"):
                for dst, v in zip(inputs, src):
                    dst.copy_(v)
            graph = Graph()
            metrics = graph.capture(lambda: self._run(state, inputs, generator),
                                    () if generator is None else (generator,))
            grads = [p.grad for p in state.model.parameters()]
            entry = self._graphs[key] = _StepGraph(binding, inputs, graph, metrics, grads,
                                                   generator)
            self.captures += 1
        else:
            with span("train.stage"):
                for dst, v in zip(entry.inputs, src):
                    dst.copy_(v, non_blocking=True)
        with span("train.replay"):
            entry.graph.replay()
        with span("train.rebind"):
            for p, g in zip(state.model.parameters(), entry.grads):
                p.grad = g
        with span("train.metrics"):
            return {k: v.clone() for k, v in entry.metrics.items()}

    @float32_matmuls()
    def __call__(self, state: TrainState, batch, generator: Optional[torch.Generator] = None):
        with span("train.step"):
            model = state.model
            model.train()
            device = next(model.parameters()).device
            b = batch[0].shape[0]
            if b % self.accum:
                data = mesh.data_size()
                raise ValueError(f"batch {b} does not split into {self.accum} microbatches"
                                 + (f" of a multiple of {data} rows (one block a data index of "
                                    f"a global batch of {b * data})" if data > 1 else ""))
            count("train.steps")
            if self.cuda_graph and device.type == "cuda":
                metrics = self._graphed(state, batch, generator)
            else:
                with span("train.eager"):
                    metrics = self._run(state, to_batch(batch, device), generator)
            state.optimizer.advance()
            state.step += 1
            return state, metrics


@contextlib.contextmanager
def eval_mode(model: CVM):
    """The model in eval mode for the block, then back in the caller's mode:
    the eval steps apply it with train=False whatever mode it is in, as the
    JAX package does (ccvpe_tpu/train/step.py:262, :279), so BN reads its
    running stats and leaves them unchanged, and no drop-connect runs, also
    on a model that is being trained."""
    was = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was)


def graph_cache(device: torch.device, cuda_graph: bool) -> Optional[GraphCache]:
    """The eval steps' graphs: a GraphCache on the card with `cuda_graph`,
    None (every call eager) otherwise."""
    return GraphCache(device) if cuda_graph and device.type == "cuda" else None


def forward_collectives(model_cfg: ModelConfig) -> bool:
    """Whether an eval-mode forward under the current mesh runs
    collectives: only where ModelConfig.spatial_axis or ori_axis names a
    model axis of more than one process (core/mesh.py). The data axis puts
    none there: an eval-mode BatchNorm reads its running stats and never
    reaches _global_batch (nn/efficientnet.py), no drop-connect runs, and
    the eval loops pool their errors on the host after the loop."""
    return mesh.shard_size(model_cfg.spatial_axis) > 1 or mesh.shard_size(model_cfg.ori_axis) > 1


class EvalStep:
    """The step make_eval_step and make_eval_decode_step return:
    step(*inputs) -> the body's tensors on the model's device, under
    torch.inference_mode, in float32 with TF32 off (core/precision.py), the
    model in eval mode (see eval_mode).

    Inputs are tensors on the host (pinned ones copy without blocking) or
    on the model's device; train/evaluate.py::pipelined hands it its pinned
    staging buffers (`takes_host_inputs`), so each batch is one
    host-to-device copy. On the card with `cuda_graph` (the counterpart of
    the JAX package's jitted eval steps) the body is one CUDA graph per
    input shapes and dtypes (core/graphs.py::GraphCache): the first call of
    a shape runs eagerly, the second captures, later calls copy the inputs
    into the graph's static inputs and replay. The graph is bound to the
    model's identity and the mesh's shape; it reads the model's parameters
    and BN buffers where they lie, so the train step's in-place updates and
    a checkpoint restored by load_state_dict are seen by the next replay.
    Outputs are clones, which the next call does not overwrite. `captures`
    counts captures. A capture that fails raises, as does a graphed call
    under NaN checks (anomaly mode cannot be captured) or where the forward
    runs collectives (forward_collectives: a model axis) under a process
    group whose collectives cannot be captured (gloo's): pass
    cuda_graph=False there, or for a reference run. A data axis alone under
    gloo graphs: its eval forward runs no collective. On the CPU every call
    runs eagerly. `weak` holds the model by a weak reference (stream_eval's
    cache of steps, which must not keep a dropped model and its graphs
    alive); a call after the model was dropped raises."""

    takes_host_inputs = True

    def __init__(self, model: CVM, body: Callable[..., Tuple[torch.Tensor, ...]],
                 cuda_graph: bool = True, weak: bool = False):
        self._model = weakref.ref(model) if weak else (lambda: model)
        self._body = body
        self.device = next(model.parameters()).device
        self.graphs = graph_cache(self.device, cuda_graph)

    @property
    def model(self) -> CVM:
        model = self._model()
        if model is None:
            raise RuntimeError("the eval step's model was dropped")
        return model

    @property
    def captures(self) -> int:
        return 0 if self.graphs is None else self.graphs.captures

    @torch.inference_mode()
    @float32_matmuls()
    def __call__(self, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with marking(self.device):
            model = self.model
            body = functools.partial(self._body, model)
            if self.graphs is None:
                return tuple(body(*(t.to(self.device, non_blocking=True) for t in inputs)))
            if torch.is_anomaly_enabled():
                raise RuntimeError("NaN checks (autograd anomaly mode) cannot run inside a CUDA "
                                   "graph: make the eval step with cuda_graph=False")
            if not mesh.capturable() and forward_collectives(model.config):
                raise RuntimeError(f"the forward's model-axis collectives cannot run inside a CUDA "
                                   f"graph under a {mesh.backend()} process group: make the eval "
                                   "step with cuda_graph=False")
            return self.graphs(body, (id(model), mesh.current_mesh()), *inputs)


def forward_maps(model: CVM, grd, sat) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval-mode forward's heatmap and ori field (the eval steps' body)."""
    with eval_mode(model):
        out = model(device_normalize(grd), device_normalize(sat))
    return out.heatmap, out.ori


def _decoded(model: CVM, grd, sat, row_offset, col_offset) -> Tuple[torch.Tensor, ...]:
    heatmap, ori = forward_maps(model, grd, sat)
    rows, cols, angle = pose.decode_pose(heatmap, ori)
    b, hs, ws = heatmap.shape[:3]
    gt_rows, gt_cols = pose.gt_location_device(hs, ws, row_offset, col_offset)
    prob_gt = heatmap[torch.arange(b, device=heatmap.device), gt_rows, gt_cols, 0]
    return rows, cols, angle, gt_rows, gt_cols, prob_gt


def make_eval_step(model: CVM, cuda_graph: bool = True) -> EvalStep:
    """(grd, sat) -> forward only, the full maps (heatmap [B,H,W,1], ori
    [B,H,W,2]) on the model's device: for where the maps themselves are the
    product (visualization, golden parity). Metric loops use
    make_eval_decode_step, which brings back six [B] vectors in place of
    the maps. One CUDA graph per shape on the card (EvalStep); a replay's
    maps come back as clones."""
    return EvalStep(model, forward_maps, cuda_graph)


def make_eval_decode_step(model: CVM, cuda_graph: bool = True) -> EvalStep:
    """(grd, sat, row_offset, col_offset) -> forward + pose decode + GT
    location + prob@GT, six [B] tensors (pred rows, cols, angle deg, GT
    rows, cols, prob@GT) on the model's device; the heatmap never leaves
    it. Images NHWC uint8 or normalized f32, offsets [B]. One CUDA graph
    per shape on the card (EvalStep)."""
    return EvalStep(model, _decoded, cuda_graph)
