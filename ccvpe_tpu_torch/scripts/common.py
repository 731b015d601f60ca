"""Flags and the TrainConfig that the three train scripts share: those of
scripts/train_{vigor,kitti,oxford}.py, the distributed ones included
(core/mesh.py::add_distributed_flags), plus --preset and --device.

Across processes, one command a process (its card cuda:(process_id %
device_count); with --device cpu, gloo on the host):
  python -m ccvpe_tpu_torch.scripts.train_vigor ... --coordinator host:port \\
      --num_processes N --process_id i
or the environment's CCVPE_COORDINATOR, CCVPE_NUM_PROCESSES and
CCVPE_PROCESS_ID. --batch_size is the global batch; each process loads its
block of batch_size / N rows."""

from __future__ import annotations

import argparse
from typing import Tuple

from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.core import mesh


def add_common_flags(p: argparse.ArgumentParser, name: str, epochs: int) -> None:
    """`name` is the full preset (vigor, kitti, oxford); runs go under runs/<name>."""
    p.add_argument("--training", default="True", choices=["True", "False"])
    p.add_argument("-l", "--learning_rate", type=float, default=1e-4)
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="sequential microbatches per optimizer step")
    p.add_argument("--weight_ori", type=float, default=1e1)
    p.add_argument("--weight_infoNCE", type=float, default=1e4)
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--workdir", default=f"runs/{name}",
                   help="metric rows, and checkpoints under <workdir>/checkpoints; a run "
                        "resumes from the newest checkpoint there")
    p.add_argument("--checkpoint", default=None,
                   help="evaluation: a reference .pt/.npz state dict, or a checkpoint "
                        "directory of the port's Trainer (its newest step)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--pretrained_backbone", default=None,
                   help="ImageNet EfficientNet-B0 weights (.pt/.pth/.npz) to fill both "
                        "encoders before training (the reference's default init, "
                        "models.py:55,99)")
    p.add_argument("--warm_start", default=None,
                   help="full reference CVM .pt/.npz state dict to start from")
    p.add_argument("--image_dtype", default="uint8", choices=["float32", "uint8"],
                   help="uint8 ships raw pixels and normalizes on the card "
                        "(4x less host-to-device traffic)")
    p.add_argument("--preset", default=name, choices=[name, "tiny"],
                   help="tiny = miniature geometry smoke mode (CPU-friendly)")
    p.add_argument("--device", default=None,
                   help="torch device; default the card, which raises without one "
                        "(pass cpu to run on the CPU)")
    mesh.add_distributed_flags(p)


def setup_processes(args) -> Tuple[int, int, int]:
    """Join the process group the flags name (nccl on the cards, gloo with
    --device cpu; nothing for one process). Returns (shard_id, num_shards,
    the local batch) for the loaders."""
    shard_id, num_shards = mesh.setup_distributed(args, device=args.device)
    if args.batch_size % num_shards or args.batch_size < num_shards:
        raise ValueError(f"global batch {args.batch_size} must be divisible by num_shards "
                         f"{num_shards} (otherwise the actual global batch silently shrinks "
                         f"and may stop dividing the mesh data axis)")
    return shard_id, num_shards, args.batch_size // num_shards


def train_config(args) -> cfg_lib.TrainConfig:
    return cfg_lib.TrainConfig(
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        grad_accum_steps=args.grad_accum, epochs=args.epochs, weight_ori=args.weight_ori,
        weight_infonce=args.weight_infoNCE, pretrained_backbone=args.pretrained_backbone,
        warm_start=args.warm_start)
