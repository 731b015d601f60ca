"""Evaluation (the port of ccvpe_tpu/train/evaluate.py): VIGOR with the
orientation prior and FoV slicing, KITTI with the longitudinal/lateral
decomposition, and the pipelined loop that train/stream.py shares.

Reference protocols: train_VIGOR.py:246-338, train_KITTI.py:281-432.

The loop keeps `pipeline_depth` batches in flight on the card. Each batch is
staged in a pinned host buffer of a small ring, zero-padded to the loader's
batch size, and copied to the card without blocking; the step's [B] results
come back without blocking into pinned host tensors, behind a CUDA event, and
are read `pipeline_depth` batches later. A slot of the ring is written again
only after its batch was read, so no copy reads a buffer being refilled.
Padded rows are dropped before any metric. On the CPU the same loop runs
synchronously, with ordinary host tensors.

Across processes (core/mesh.py) each process walks its shard of the loader
and the raw per-sample errors of every process are pooled
(mesh.all_hosts_concat) before any median or recall, as in the JAX
package (ccvpe_tpu/train/evaluate.py:121-125): every process returns the
summary of the whole set.

Entry points take `device=None` as the card and raise without one; pass
device="cpu" to run on the CPU.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.core.checkpoint import latest_model_state
from ccvpe_tpu_torch.data.kitti import KittiDataset
from ccvpe_tpu_torch.data.loader import ThreadedLoader
from ccvpe_tpu_torch.data.vigor import VIGORDataset
from ccvpe_tpu_torch.models.cvm import CVM, build_cvm, resolve_device
from ccvpe_tpu_torch.ops import pose
from ccvpe_tpu_torch.train.step import make_eval_decode_step
from ccvpe_tpu_torch.utils.convert import load_state_dict_file


def check_shards(loader, what: str, shard_id: Optional[int] = None,
                 num_shards: Optional[int] = None) -> None:
    """Refuse a loader (or the shard_id / num_shards given) that is not this
    process's shard of the data: (shard_id, num_shards) must be (rank,
    world size), (0, 1) for one process."""
    sid = getattr(loader, "shard_id", 0) if shard_id is None else shard_id
    n = getattr(loader, "num_shards", 1) if num_shards is None else num_shards
    if (sid, n) != (mesh.rank(), mesh.world_size()):
        raise ValueError(f"{what} over shard {sid} of {n}: this is process {mesh.rank()} of "
                         f"{mesh.world_size()}, whose shard is {mesh.rank()} of "
                         f"{mesh.world_size()}")


def load_model(model_cfg: cfg_lib.ModelConfig, checkpoint: str, device) -> CVM:
    """A CVM in eval mode on `device` from a reference .pt/.pth state dict,
    an .npz of the same keys (utils/convert.py::load_state_dict_file), or a
    directory of the Trainer's checkpoints (core/checkpoint.py), whose
    newest step gives the model. Any other directory raises."""
    sd = latest_model_state(checkpoint) if os.path.isdir(checkpoint) else None
    if sd is None:
        sd = load_state_dict_file(checkpoint)
    return build_cvm(model_cfg, device, state_dict=sd)


def slice_fov(grd: np.ndarray, fov: int) -> np.ndarray:
    """FoV testing without retraining: keep the first W*FoV/360 columns
    (train_VIGOR.py:272-273). NHWC."""
    width = int(grd.shape[2] * fov / 360)
    return grd[:, :, :width, :]


class _Slot:
    """One batch in flight: pinned staging buffers for its inputs, pinned
    host tensors for its results, and the event after the result copies."""

    def __init__(self):
        self.inputs: List[torch.Tensor] = []
        self.outputs: List[torch.Tensor] = []
        self.done: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        if self.done is not None:
            self.done.synchronize()
            self.done = None


def _host_buffer(buf: Optional[torch.Tensor], shape, dtype, pin: bool) -> torch.Tensor:
    if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
        buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
    return buf


def pipelined(step: Callable[..., Sequence[torch.Tensor]], batches: Iterable,
              inputs: Callable[[dict], Tuple[np.ndarray, ...]], batch_size: int,
              device: torch.device, depth: int = 4
              ) -> Iterator[Tuple[List[np.ndarray], dict]]:
    """Run `step` on every raw batch with up to `depth` batches in flight.

    `inputs(raw)` gives the step's host arrays, each with the batch's rows
    first; a batch of fewer than `batch_size` rows is zero-padded to it.
    Yields, in order, (the step's outputs as numpy arrays cut to the batch's
    own rows, raw)."""
    depth = max(1, depth)
    pin = device.type == "cuda"
    ring = [_Slot() for _ in range(depth + 1)]
    pending: collections.deque = collections.deque()   # (slot, rows, raw)

    def dispatch(slot: _Slot, raw: dict) -> int:
        slot.wait()
        arrays = inputs(raw)
        rows = len(arrays[0])
        if rows > batch_size:
            raise ValueError(f"a batch of {rows} rows exceeds the batch size {batch_size}")
        srcs = [torch.as_tensor(a) for a in arrays]
        if len(slot.inputs) != len(srcs):
            slot.inputs = [None] * len(srcs)
        slot.inputs = [_host_buffer(buf, (batch_size, *src.shape[1:]), src.dtype, pin)
                       for buf, src in zip(slot.inputs, srcs)]
        for buf, src in zip(slot.inputs, srcs):
            buf[:rows].copy_(src)
            buf[rows:].zero_()
        outs = step(*(buf.to(device, non_blocking=True) for buf in slot.inputs))
        if len(slot.outputs) != len(outs):
            slot.outputs = [None] * len(outs)
        slot.outputs = [_host_buffer(h, o.shape, o.dtype, pin)
                        for h, o in zip(slot.outputs, outs)]
        for h, o in zip(slot.outputs, outs):
            h.copy_(o, non_blocking=True)
        if pin:
            slot.done = torch.cuda.Event()
            slot.done.record()
        return rows

    def collect(slot: _Slot, rows: int, raw: dict):
        slot.wait()
        return [h[:rows].numpy().copy() for h in slot.outputs], raw

    for i, raw in enumerate(batches):
        slot = ring[i % len(ring)]
        pending.append((slot, dispatch(slot, raw), raw))
        if len(pending) > depth:
            yield collect(*pending.popleft())
    while pending:
        yield collect(*pending.popleft())


def eval_over_loader(
    decode_step,
    loader,
    meters_per_pixel,
    fov: Optional[int] = None,
    with_prob_at_gt: bool = False,
    with_recalls: bool = True,
    pipeline_depth: int = 4,
    device=None,
) -> Dict[str, float]:
    """The metric loop over one eval loader: pose decode, metres,
    orientation error, longitudinal/lateral decomposition and recalls
    @1/3/5 m and deg (train_VIGOR.py:290-326, train_KITTI.py:320-360).

    `decode_step` is train/step.py::make_eval_decode_step's step, on
    `device` (default the card): six [B] vectors come back per batch, never
    the maps. `meters_per_pixel` is a float, or a callable city -> float
    applied to the batch's "city" field (VIGOR's per-city scales,
    train_VIGOR.py:193-200). Across processes `loader` is this process's
    shard (shard_id, num_shards = rank, world size), and the summary is
    that of every process's samples together."""
    check_shards(loader, "eval_over_loader")
    device = resolve_device(device)
    dist, ori_err, longi, lat, prob = [], [], [], [], []

    def inputs(raw):
        grd = slice_fov(raw["grd"], fov) if fov and fov != 360 else raw["grd"]
        return (grd, raw["sat"], np.asarray(raw["row_offset"], np.float32),
                np.asarray(raw["col_offset"], np.float32))

    for decoded, raw in pipelined(decode_step, loader, inputs, loader.batch_size, device,
                                  pipeline_depth):
        rows, cols, angle_pred, gt_rows, gt_cols, prob_gt = decoded
        px = np.sqrt((gt_rows - rows) ** 2.0 + (gt_cols - cols) ** 2.0)
        if callable(meters_per_pixel):
            mpp = (np.array([meters_per_pixel(c) for c in raw["city"]])
                   if "city" in raw else meters_per_pixel(None))
        else:
            mpp = meters_per_pixel
        dist.extend(np.atleast_1d(px * mpp).tolist())
        ori_err.extend(pose.angle_error(angle_pred, raw["angle_deg"]).tolist())
        lo, la = pose.longitudinal_lateral(rows, cols, gt_rows, gt_cols, raw["angle_deg"], mpp)
        longi.extend(lo.tolist())
        lat.extend(la.tolist())
        if with_prob_at_gt:
            prob.extend(prob_gt.tolist())
    # every process's raw per-sample errors, so that medians and recalls are
    # over the whole set
    dist, ori_err, longi, lat = (mesh.all_hosts_concat(a).tolist()
                                 for a in (dist, ori_err, longi, lat))
    if with_prob_at_gt:
        prob = mesh.all_hosts_concat(prob).tolist()
    summary = pose.summarize(np.array(dist), np.array(ori_err),
                             np.array(prob) if prob else None)
    if with_recalls:
        summary.update(recall_summary(longi, lat, ori_err))
    return summary


def recall_summary(longi, lat, ori_err) -> Dict[str, float]:
    """long_/lat_recall@1/3/5 (m) and ori_recall@1/3/5deg."""
    out = {f"long_{k}": v for k, v in pose.recalls(np.array(longi)).items()}
    out.update({f"lat_{k}": v for k, v in pose.recalls(np.array(lat)).items()})
    out.update({k.replace("recall@", "ori_recall@") + "deg": v
                for k, v in pose.recalls(np.array(ori_err)).items()})
    return out


def evaluate_vigor(args, ori_noise: float, circular: bool, device=None) -> Dict[str, float]:
    """The VIGOR test split: `args` carries root, area, checkpoint,
    batch_size, num_workers and FoV. At ori_noise 180 the fixed test
    orientations (data/fixtures.py) roll the panoramas; it raises where no
    fixture exists rather than draw fresh ones (train_VIGOR.py:73-79)."""
    device = resolve_device(device)
    random_orientation = None
    if ori_noise == 180.0:
        from ccvpe_tpu_torch.data.fixtures import load_orientation_fixture
        random_orientation = load_orientation_fixture(args.area)
    dataset = VIGORDataset(args.root, split=args.area, train=False, ori_noise=ori_noise,
                           random_orientation=random_orientation)
    model_cfg = cfg_lib.vigor(ori_noise=ori_noise if ori_noise < 180 else None,
                              circular=circular)
    model = load_model(model_cfg, args.checkpoint, device)
    loader = ThreadedLoader(dataset, args.batch_size, shuffle=False,
                            num_workers=args.num_workers, drop_last=False)
    summary = eval_over_loader(make_eval_decode_step(model), loader,
                               dataset.meters_per_pixel, fov=args.FoV, with_prob_at_gt=True,
                               with_recalls=False, device=device)
    for k, v in summary.items():
        print(f"{k}: {v:.4f}")
    return summary


def evaluate_kitti(args, device=None) -> Dict[str, Dict[str, float]]:
    """test1/test2 with the longitudinal/lateral decomposition and recalls
    (train_KITTI.py:281-432). `args` carries root, test1_file, test2_file,
    checkpoint, batch_size, num_workers and the shift and rotation ranges."""
    device = resolve_device(device)
    model = load_model(cfg_lib.kitti(), args.checkpoint, device)
    decode_step = make_eval_decode_step(model)
    results = {}
    for name, file in (("test1", args.test1_file), ("test2", args.test2_file)):
        dataset = KittiDataset(args.root, file, train=False,
                               shift_range_lat=args.shift_range_lat,
                               shift_range_lon=args.shift_range_lon,
                               rotation_range=args.rotation_range)
        loader = ThreadedLoader(dataset, args.batch_size, shuffle=False,
                                num_workers=args.num_workers, drop_last=False)
        # decomposed against the GT orientation angle (degrees from North),
        # not the raw oxts heading (train_KITTI.py:320-327)
        results[name] = eval_over_loader(decode_step, loader, dataset.meters_per_pixel(),
                                         device=device)
        print(name, results[name])
    return results
