"""Sequential streaming evaluation, the Oxford RobotCar workload (the port
of ccvpe_tpu/train/stream.py; reference train_OxfordRobotCar.py:195-397).

Frames are independent given the deterministic tile rule (reference
datasets.py:306-321). `stream_eval` runs one traversal's frames through the
forward and the pose decode on the card, brings back three [B] vectors per
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
from typing import Dict, Sequence

import numpy as np
import torch

from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.core.config import ModelConfig
from ccvpe_tpu_torch.data.loader import ThreadedLoader
from ccvpe_tpu_torch.models.cvm import CVM, resolve_device
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.train.evaluate import check_shards, pipelined, recall_summary
from ccvpe_tpu_torch.train.step import make_eval_step


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
) -> Dict[str, float]:
    """Evaluate one traversal's frames in order; returns the summary,
    `fps`, `aggregate_fps` and `frames`. `model` must lie on `device`
    (default the card). `eval_step` is a full-map step
    (train/step.py::make_eval_step), by default that of `model`, which runs
    it in eval mode whatever mode it is in. (shard_id, num_shards) must be
    this process's (rank, world size)."""
    check_shards(None, "stream_eval", shard_id, num_shards)
    device = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != device.type or (device.index is not None and on.index != device.index):
        raise ValueError(f"the model lies on {on}, not on {device}")
    hs, ws = model_cfg.sat_size
    base_step = eval_step if eval_step is not None else make_eval_step(model)

    @torch.inference_mode()
    def decode_step(grd, sat):
        return pose.decode_pose(*base_step(grd, sat))

    loader = ThreadedLoader(dataset, batch_size, shuffle=False, num_workers=num_workers,
                            indices=list(indices), drop_last=False, shard_id=shard_id,
                            num_shards=num_shards)
    dist, ori_err, longi, lat = [], [], [], []
    t0 = time.perf_counter()
    for (rows, cols, angle_pred), raw in pipelined(
            decode_step, loader, lambda raw: (raw["grd"], raw["sat"]), batch_size, device,
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
