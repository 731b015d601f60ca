"""KITTI training and evaluation on the card (the port of
scripts/train_kitti.py; reference train_KITTI.py).

  python -m ccvpe_tpu_torch.scripts.train_kitti --root /data/KITTI \\
      --train_file train.txt --test1_file test1.txt --test2_file test2.txt
"""

from __future__ import annotations

import argparse

from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.scripts.common import add_common_flags, setup_processes, train_config


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="KITTI dataset root")
    p.add_argument("--train_file", required=False)
    p.add_argument("--test1_file", required=False)
    p.add_argument("--test2_file", required=False)
    p.add_argument("--shift_range_lat", type=float, default=20)
    p.add_argument("--shift_range_lon", type=float, default=20)
    p.add_argument("--rotation_range", type=float, default=180)
    add_common_flags(p, "kitti", epochs=6)
    args = p.parse_args(argv)
    shard_id, num_shards, local_bs = setup_processes(args)

    if args.training == "True":
        from ccvpe_tpu_torch.data import kitti as kitti_data
        from ccvpe_tpu_torch.data.loader import ThreadedLoader
        from ccvpe_tpu_torch.train.trainer import Trainer

        # the tiny preset keeps the dataset's aerial crop (SAT_SIZE)
        model_cfg = (cfg_lib.tiny(sat=kitti_data.SAT_SIZE) if args.preset == "tiny"
                     else cfg_lib.kitti())
        ranges = dict(shift_range_lat=args.shift_range_lat,
                      shift_range_lon=args.shift_range_lon,
                      rotation_range=args.rotation_range, grd_size=model_cfg.grd_size)
        train_set = kitti_data.KittiDataset(args.root, args.train_file, train=True,
                                            image_dtype=args.image_dtype, **ranges)
        # the reference evaluates test1 (same traversals) AND test2
        # (held-out) every epoch (train_KITTI.py:168-279)
        eval_sets = {name: kitti_data.KittiDataset(args.root, file, train=False, **ranges)
                     for name, file in (("test1", args.test1_file), ("test2", args.test2_file))
                     if file}
        trainer = Trainer(model_cfg, train_config(args), workdir=args.workdir,
                          device=args.device)
        trainer.fit(
            train_loader_fn=lambda epoch: ThreadedLoader(
                train_set, local_bs, shuffle=True, seed=epoch,
                num_workers=args.num_workers, shard_id=shard_id, num_shards=num_shards),
            val_loader_fn=lambda epoch: {
                name: ThreadedLoader(ds, local_bs, shuffle=False,
                                     num_workers=args.num_workers,
                                     shard_id=shard_id, num_shards=num_shards)
                for name, ds in eval_sets.items()},
            meters_per_pixel=train_set.meters_per_pixel,
        )
        return trainer
    from ccvpe_tpu_torch.train.evaluate import evaluate_kitti
    return evaluate_kitti(args, device=args.device)


if __name__ == "__main__":
    main()
