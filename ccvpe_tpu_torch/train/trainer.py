"""Epoch driver: training, per-epoch validation, checkpoints with exact
resume (the port of ccvpe_tpu/train/trainer.py:30-201).

Replaces the reference per-script loops (reference train_VIGOR.py:96-244,
train_KITTI.py, train_OxfordRobotCar.py) with one driver over the config:
train steps (one CUDA graph a batch shape on the card) fed by a prefetching
copy to the card, the eval decode step (one CUDA graph a batch shape too)
over named validation sets, asynchronous checkpoints of the full state
resumed at the exact (epoch, batch), and CSV/JSONL metric rows.

Across processes (core/mesh.py: one process a card, the default process
group as the data axis named by TrainConfig.data_axis; a model axis,
TrainConfig.model_axis, of size 1) every process runs the same steps on its
block of each global batch, from a loader whose (shard_id, num_shards) are
its (rank, world size); any other loader is refused. The state is
broadcast from process 0 after its initial weights; process 0 writes the
checkpoints, behind a barrier, and every process restores them; metric rows
and prints come from process 0; validation pools every process's
per-sample errors (train/evaluate.py).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from ccvpe_tpu_torch.core import mesh
from ccvpe_tpu_torch.core.checkpoint import CheckpointManager
from ccvpe_tpu_torch.core.config import ModelConfig, TrainConfig
from ccvpe_tpu_torch.core.metrics import MetricWriter
from ccvpe_tpu_torch.train.evaluate import _host_buffer, _Slot, check_shards, eval_over_loader
from ccvpe_tpu_torch.train.step import (Batch, create_train_state, make_eval_decode_step,
                                        make_optimizer, make_train_step)
from ccvpe_tpu_torch.utils.convert import init_with_pretrained_backbone, load_state_dict_file


def batch_from_numpy(b: Dict[str, np.ndarray]) -> Batch:
    return Batch(grd=b["grd"], sat=b["sat"], row_offset=b["row_offset"],
                 col_offset=b["col_offset"], angle_deg=b["angle_deg"])


def device_prefetch(loader: Iterable[Dict[str, np.ndarray]], device,
                    depth: int = 2) -> Iterator[Batch]:
    """Iterate a host loader `depth` batches ahead of the consumer, as Batches
    of tensors on `device`. Each batch is staged in a pinned slot of a ring
    and copied to the card without blocking, on the current stream, behind
    the steps already queued; a slot is written again only after the event
    recorded after its copy (train/evaluate.py::pipelined's discipline), so
    no copy reads a buffer being refilled. On the CPU the batch's own arrays
    are handed on."""
    device = torch.device(device)
    pin = device.type == "cuda"
    ring = [_Slot() for _ in range(depth + 1)]
    pending: collections.deque = collections.deque()

    def stage(slot: _Slot, raw: Dict[str, np.ndarray]) -> Batch:
        srcs = [torch.as_tensor(np.asarray(a)) for a in batch_from_numpy(raw)]
        if not pin:
            return Batch(*srcs)
        slot.wait()
        if len(slot.inputs) != len(srcs):
            slot.inputs = [None] * len(srcs)
        slot.inputs = [_host_buffer(buf, src.shape, src.dtype, True)
                       for buf, src in zip(slot.inputs, srcs)]
        for buf, src in zip(slot.inputs, srcs):
            buf.copy_(src)
        batch = Batch(*(buf.to(device, non_blocking=True) for buf in slot.inputs))
        slot.done = torch.cuda.Event()
        slot.done.record()
        return batch

    for i, raw in enumerate(loader):
        pending.append(stage(ring[i % len(ring)], raw))
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def step_seed(seed: int, step: int) -> int:
    """The seed of the drop-connect masks of the update that follows `step`
    earlier ones: a 64-bit mix of (TrainConfig.seed + 1, step), the port's
    counterpart of JAX's fold_in(PRNGKey(seed + 1), state.step)
    (ccvpe_tpu/train/step.py:218, trainer.py:190). A function of the step
    alone, so a resumed run draws the masks an uninterrupted one draws
    without storing any generator state."""
    return int(np.random.SeedSequence([seed + 1, step]).generate_state(1, np.uint64)[0])


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 workdir: str = "runs/default", device=None):
        """Weights drawn from torch.Generator seed train_cfg.seed, on `device`
        (default this process's card, cuda:(rank % device_count), which
        raises without one). The newest checkpoint
        under workdir/train_cfg.checkpoint_dir, if any, wins over a warm
        start or a pretrained backbone. The train step and the validation
        step run as CUDA graphs on the card (make_train_step's and
        make_eval_decode_step's cuda_graph), unless NaN checks
        (core/debug.py) are on when the Trainer is made: anomaly mode cannot
        be captured. A restored state is another binding of the train step:
        its first step runs eagerly and the next captures anew; the
        validation step's graph stays, as the restore copies into the
        model's tensors."""
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.mesh = mesh.make_mesh(axis_names=(train_cfg.data_axis, train_cfg.model_axis))
        self.is_main = mesh.is_main()
        self.device = mesh.process_device(device)
        self.state = create_train_state(model_cfg, train_cfg,
                                        torch.Generator().manual_seed(train_cfg.seed),
                                        device=self.device)
        graphed = not torch.is_anomaly_enabled()
        self.train_step = make_train_step(model_cfg, train_cfg, cuda_graph=graphed)
        # the scalar eval step on the model being trained (it runs it in eval
        # mode), built once: on the card one CUDA graph a batch shape, which
        # each validate() replays on the weights and BN stats the train
        # step changed in place; it brings back [B] vectors, never the maps
        self.eval_step = make_eval_decode_step(self.state.model, cuda_graph=graphed)
        # drop-connect's masks, re-seeded before every step (step_seed)
        self.generator = torch.Generator(device=self.device)
        self.metrics = MetricWriter(workdir, model_cfg.name) if self.is_main else None
        self.ckpt = CheckpointManager(f"{workdir}/{train_cfg.checkpoint_dir}",
                                      keep=train_cfg.keep_checkpoints)
        self.restored = False
        self.cursor = {"epoch": 0, "batch": 0}
        restored = self.ckpt.restore_latest(self.state)
        if restored is not None:
            self.state, self.cursor = restored
            self.restored = True
            self._print(f"resumed from step {self.state.step} "
                        f"(epoch {self.cursor['epoch']}, batch {self.cursor['batch']})")
        else:
            if train_cfg.warm_start or train_cfg.pretrained_backbone:
                self._apply_initial_weights()
            mesh.replicate(self.state.model)

    def _print(self, *parts) -> None:
        if self.is_main:
            print(*parts)

    def _save(self, cursor: dict) -> None:
        """Process 0 saves the state at this step (asynchronously); the
        others go on: their state is the same."""
        if self.is_main:
            self.ckpt.save(self.state.step, self.state, cursor=cursor)

    def _wait(self) -> None:
        """Process 0's write on disk, then every process past the barrier."""
        self.ckpt.wait()
        mesh.barrier()

    def _apply_initial_weights(self) -> None:
        """Fill weights before the first step: either a full reference CVM
        warm start (.pt or .npz, loaded strictly), or ImageNet
        EfficientNet-B0 weights into BOTH encoders (the reference's default
        init, models.py:55,99 + efficientnet_pytorch/utils.py:729-758, which
        the published accuracy rests on). The optimizer state is made
        afresh."""
        cfg = self.train_cfg
        model = self.state.model
        if cfg.warm_start:
            model.load_state_dict(load_state_dict_file(cfg.warm_start), strict=True)
            self._print(f"warm start from {cfg.warm_start}")
        else:
            init_with_pretrained_backbone(model, load_state_dict_file(cfg.pretrained_backbone))
            self._print(f"pretrained backbone init from {cfg.pretrained_backbone}")
        self.state.optimizer = make_optimizer(model.parameters(), cfg)

    def _log(self, epoch: int, i: int, running, pairs: int, t_last: float) -> None:
        """One metric row: the mean of each of the last steps' metrics (one
        read from the card for the window; the global batch's, the same on
        every process), and the global batch's pairs/s over its wall time.
        Written and printed by process 0."""
        keys = list(running[0])
        means = torch.stack([torch.stack([m[k] for m in running]) for k in keys])
        vals = dict(zip(keys, means.double().mean(dim=1).tolist()))
        vals["pairs_per_s"] = pairs / (time.perf_counter() - t_last)
        if self.is_main:
            self.metrics.write(self.state.step, vals)
        self._print(f"[{epoch}, {i + 1}] loss: {vals['loss']:.3f} "
                    f"({vals['pairs_per_s']:.2f} pairs/s)")

    def train_epoch(self, loader: Iterable[Dict[str, np.ndarray]], epoch: int,
                    start_batch: int = 0) -> None:
        """Run one epoch, optionally resuming at `start_batch` within the
        epoch's deterministic shuffle (exact mid-epoch resume). Checkpoints
        record the NEXT position to run as an (epoch, batch) cursor. The
        step's metrics stay on the card until a log row averages them.
        Across processes the loader yields this process's block of each
        global batch: its (shard_id, num_shards) must be (rank, world size)."""
        check_shards(loader, "training")
        cfg = self.train_cfg
        if start_batch:
            if hasattr(loader, "start_batch"):
                loader.start_batch = start_batch   # skip without decoding
            else:
                it = iter(loader)
                for _ in range(start_batch):
                    next(it)
                loader = it
        t_last = time.perf_counter()
        running, pairs = [], 0
        for j, batch in enumerate(device_prefetch(loader, self.device)):
            i = start_batch + j   # batch index within the epoch's shuffle
            self.generator.manual_seed(step_seed(cfg.seed, self.state.step))
            self.state, m = self.train_step(self.state, batch, self.generator)
            running.append(m)
            pairs += batch.grd.shape[0] * self.mesh.data
            step = self.state.step
            if cfg.checkpoint_every_steps and step % cfg.checkpoint_every_steps == 0:
                self._save({"epoch": epoch, "batch": i + 1})
            if cfg.fake_fail_at_step is not None and step == cfg.fake_fail_at_step:
                self._wait()
                raise RuntimeError(f"fake failure injected at step {step}")
            if (j + 1) % cfg.log_every == 0:
                self._log(epoch, i, running, pairs, t_last)
                running, pairs, t_last = [], 0, time.perf_counter()
        self._save({"epoch": epoch + 1, "batch": 0})

    def validate(self, loaders, meters_per_pixel, epoch: int):
        """Per-epoch evaluation through eval_over_loader. `loaders` is one
        loader, or a dict of named eval sets evaluated every epoch (the KITTI
        protocol runs test1 AND test2 each epoch, reference
        train_KITTI.py:168-279); recalls @1/3/5 m and deg are in every row.
        Across processes each loader is this process's shard, and the
        summary pools every process's samples; process 0 writes the rows."""
        named = loaders if isinstance(loaders, dict) else {"val": loaders}
        results = {}
        for name, loader in named.items():
            summary = eval_over_loader(self.eval_step, loader, meters_per_pixel,
                                       device=self.device)
            if self.is_main:
                self.metrics.write(self.state.step,
                                   {f"{name}/{k}": v for k, v in summary.items()})
            self._print(f"epoch {epoch} {name}: {summary}")
            results[name] = summary
        return results if isinstance(loaders, dict) else results["val"]

    def fit(self, train_loader_fn: Callable[[int], Iterable], val_loader_fn: Callable[[int], object],
            meters_per_pixel, epochs: Optional[int] = None) -> None:
        total_epochs = epochs or self.train_cfg.epochs
        # exact resume: the checkpointed cursor names the next (epoch, batch)
        # to run under each epoch's deterministic shuffle
        start_epoch = min(self.cursor["epoch"], total_epochs) if self.restored else 0
        start_batch = self.cursor["batch"] if self.restored else 0
        for epoch in range(start_epoch, total_epochs):
            self.train_epoch(train_loader_fn(epoch), epoch,
                             start_batch=start_batch if epoch == start_epoch else 0)
            self.validate(val_loader_fn(epoch), meters_per_pixel, epoch)
        self._wait()
