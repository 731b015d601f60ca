"""Oxford RobotCar training and streaming evaluation on the card (the port
of scripts/train_oxford.py; reference train_OxfordRobotCar.py).

  python -m ccvpe_tpu_torch.scripts.train_oxford --grd_root /data/oxford/ \\
      --sat_path /data/oxford/satellite_map_new.png
"""

from __future__ import annotations

import argparse

import numpy as np

from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.scripts.common import add_common_flags, setup_processes, train_config


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grd_root", required=True, help="ground image root")
    p.add_argument("--sat_path", required=True, help="stitched aerial map path")
    add_common_flags(p, "oxford", epochs=50)
    args = p.parse_args(argv)
    shard_id, num_shards, local_bs = setup_processes(args)

    from ccvpe_tpu_torch.data import oxford as oxford_data
    from ccvpe_tpu_torch.data.loader import ThreadedLoader

    # the tiny preset keeps the dataset's aerial output size (OUT)
    model_cfg = (cfg_lib.tiny(sat=oxford_data.OUT) if args.preset == "tiny"
                 else cfg_lib.oxford())
    if args.training == "True":
        from ccvpe_tpu_torch.train.trainer import Trainer

        train_set = oxford_data.OxfordDataset(args.grd_root, args.sat_path, split="train",
                                              grd_size=model_cfg.grd_size,
                                              image_dtype=args.image_dtype)
        val_set = oxford_data.OxfordDataset(args.grd_root, args.sat_path, split="val",
                                            grd_size=model_cfg.grd_size,
                                            image_dtype=args.image_dtype)
        trainer = Trainer(model_cfg, train_config(args), workdir=args.workdir,
                          device=args.device)
        trainer.fit(
            train_loader_fn=lambda epoch: ThreadedLoader(
                train_set, local_bs, shuffle=True, seed=epoch,
                num_workers=args.num_workers, shard_id=shard_id, num_shards=num_shards),
            val_loader_fn=lambda epoch: ThreadedLoader(
                val_set, local_bs, shuffle=False, num_workers=args.num_workers,
                shard_id=shard_id, num_shards=num_shards),
            meters_per_pixel=train_set.meters_per_pixel,
        )
        return trainer

    # sequential per-frame streaming eval over the 3 test traversals
    # (train_OxfordRobotCar.py:195-397), long/lat decomposition included
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.train.evaluate import load_model
    from ccvpe_tpu_torch.train.stream import stream_eval

    device = mesh.process_device(args.device)
    dataset = oxford_data.OxfordDataset(args.grd_root, args.sat_path, split="test",
                                        grd_size=model_cfg.grd_size)
    model = load_model(model_cfg, args.checkpoint, device)
    bounds = np.cumsum((0,) + dataset.traversal_lens)
    summaries = []
    for t in range(3):
        summary = stream_eval(model, model_cfg, dataset,
                              indices=range(bounds[t], bounds[t + 1]),
                              batch_size=local_bs,
                              meters_per_pixel=dataset.meters_per_pixel(),
                              num_workers=args.num_workers, shard_id=shard_id,
                              num_shards=num_shards, device=device)
        fps = summary.pop("fps")
        if shard_id == 0:
            print(f"traversal {t + 1}: {summary} stream rate {fps:.1f} FPS/process")
        summaries.append(summary)
    return summaries


if __name__ == "__main__":
    main()
