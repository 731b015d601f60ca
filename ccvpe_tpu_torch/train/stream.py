"""Sequential streaming evaluation, the Oxford RobotCar workload (the port
of ccvpe_tpu/train/stream.py; reference train_OxfordRobotCar.py:195-397).

Frames are independent given the deterministic tile rule (reference
datasets.py:306-321). `stream_eval` runs one traversal's frames through the
forward and the pose decode on the card (one CUDA graph a batch shape,
kept across calls on the same model), brings back three [B] vectors per
batch (rows, cols, angle), never the maps, and keeps `pipeline_depth`
batches in flight (train/evaluate.py::pipelined: pinned staging, copies
that do not block, an event per batch). It returns the summary (mean and
median metres and degrees, longitudinal/lateral and orientation recalls)
and the stream's frames per second, host decoding and copies included.

Across processes (core/mesh.py) each process streams its shard of the
traversal (shard_id, num_shards = rank, world size) and the raw per-frame
errors are pooled before the summary, as in the JAX package
(ccvpe_tpu/train/stream.py:132-151): `fps` is this process's rate,
`aggregate_fps` the frames of every process over this process's wall time,
`frames` every process's count.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.core.config import ModelConfig
from ccvpe_tpu_torch.data.loader import ThreadedLoader
from ccvpe_tpu_torch.models.cvm import CVM, resolve_device
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.train.evaluate import check_shards, pipelined, recall_summary
from ccvpe_tpu_torch.train.step import EvalStep, forward_maps

# The graphed forward + decode step of each model, kept across stream_eval
# calls (the counterpart of ccvpe_tpu/train/stream.py's _DECODE_STEP_CACHE:
# a fresh step a call would capture anew every traversal). Keyed by the
# model, held weakly, and each step holds its model weakly too, so a
# dropped model takes its entry and its graphs' memory pools with it.
_DECODE_STEPS: "weakref.WeakKeyDictionary[CVM, EvalStep]" = weakref.WeakKeyDictionary()


def _decoded_pose(model: CVM, grd, sat) -> Tuple[torch.Tensor, ...]:
    """Forward and pose decode: only three [B] vectors leave the step."""
    return pose.decode_pose(*forward_maps(model, grd, sat))


def decode_step(model: CVM) -> EvalStep:
    """stream_eval's default step for `model`: forward + pose decode, one
    CUDA graph a batch shape on the card, cached (_DECODE_STEPS)."""
    step = _DECODE_STEPS.get(model)
    if step is None:
        step = _DECODE_STEPS[model] = EvalStep(model, _decoded_pose, weak=True)
    return step


def stream_eval(
    model: CVM,
    model_cfg: ModelConfig,
    dataset,
    indices: Sequence[int],
    batch_size: int = 8,
    meters_per_pixel: float = 1.0,
    num_workers: int = 8,
    shard_id: int = 0,
    num_shards: int = 1,
    eval_step=None,
    pipeline_depth: int = 4,
    device=None,
    cuda_graph: bool = True,
) -> Dict[str, float]:
    """Evaluate one traversal's frames in order; returns the summary,
    `fps`, `aggregate_fps` and `frames`. `model` must lie on `device`
    (default the card). With `eval_step` None, the forward (in eval mode
    whatever mode the model is in) and the pose decode run as one step, on
    the card one CUDA graph a batch shape, kept across calls on the same
    model (decode_step); `cuda_graph=False` runs them eagerly (train/step.py::
    EvalStep says where that is needed). A caller's `eval_step` is a
    full-map step (train/step.py::make_eval_step), called as given, its
    maps decoded after it. (shard_id, num_shards) must be this process's
    (rank, world size)."""
    check_shards(None, "stream_eval", shard_id, num_shards)
    device = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != device.type or (device.index is not None and on.index != device.index):
        raise ValueError(f"the model lies on {on}, not on {device}")
    hs, ws = model_cfg.sat_size
    if eval_step is None:
        step = decode_step(model) if cuda_graph else EvalStep(model, _decoded_pose, False)
    else:
        @torch.inference_mode()
        def step(grd, sat):
            return pose.decode_pose(*eval_step(grd, sat))

    loader = ThreadedLoader(dataset, batch_size, shuffle=False, num_workers=num_workers,
                            indices=list(indices), drop_last=False, shard_id=shard_id,
                            num_shards=num_shards)
    dist, ori_err, longi, lat = [], [], [], []
    t0 = time.perf_counter()
    for (rows, cols, angle_pred), raw in pipelined(
            step, loader, lambda raw: (raw["grd"], raw["sat"]), batch_size, device,
            pipeline_depth):
        gt_rows, gt_cols = pose.gt_location(hs, ws, raw["row_offset"], raw["col_offset"])
        px = np.sqrt((gt_rows - rows) ** 2 + (gt_cols - cols) ** 2)
        dist.extend((px * meters_per_pixel).tolist())
        # decomposed against the GT orientation angle
        # (train_OxfordRobotCar.py:248-266)
        lo, la = pose.longitudinal_lateral(rows, cols, gt_rows, gt_cols, raw["angle_deg"],
                                           meters_per_pixel)
        longi.extend(lo.tolist())
        lat.extend(la.tolist())
        ori_err.extend(pose.angle_error(angle_pred, raw["angle_deg"]).tolist())
    elapsed = time.perf_counter() - t0

    local_n = len(dist)
    # every process's raw per-frame errors: medians and recalls over the
    # whole traversal, not one process's stride
    dist, ori_err, longi, lat = (mesh.all_hosts_concat(a).tolist()
                                 for a in (dist, ori_err, longi, lat))
    n = len(dist)
    summary = pose.summarize(np.array(dist), np.array(ori_err))
    summary.update(recall_summary(longi, lat, ori_err))
    summary["fps"] = local_n / elapsed if elapsed > 0 else 0.0
    summary["aggregate_fps"] = n / elapsed if elapsed > 0 else 0.0
    summary["frames"] = float(n)
    return summary
