"""VIGOR training and evaluation on the card (the port of
scripts/train_vigor.py; reference train_VIGOR.py).

Training (resumes from <workdir>/checkpoints when a run is there):
  python -m ccvpe_tpu_torch.scripts.train_vigor --root /data/VIGOR --area samearea
Evaluation with orientation prior and FoV slicing:
  python -m ccvpe_tpu_torch.scripts.train_vigor --root /data/VIGOR --training False \\
      --ori_noise 72 --FoV 360 --checkpoint runs/vigor/checkpoints
"""

from __future__ import annotations

import argparse

import numpy as np

from ccvpe_tpu_torch.core import config as cfg_lib
from ccvpe_tpu_torch.scripts.common import add_common_flags, setup_processes, train_config


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="VIGOR dataset root")
    p.add_argument("--area", default="samearea", choices=["samearea", "crossarea"])
    p.add_argument("--pos_only", default="True", choices=["True", "False"])
    p.add_argument("-f", "--FoV", type=int, default=360)
    p.add_argument("--ori_noise", type=float, default=180.0)
    add_common_flags(p, "vigor", epochs=15)
    args = p.parse_args(argv)
    shard_id, num_shards, local_bs = setup_processes(args)

    # round ori_noise to the bin grid (train_VIGOR.py:49)
    ori_noise = 18.0 * (args.ori_noise // 18.0)
    circular = args.FoV == 360

    if args.training == "True":
        from ccvpe_tpu_torch.data.loader import ThreadedLoader
        from ccvpe_tpu_torch.data.vigor import VIGORDataset
        from ccvpe_tpu_torch.train.trainer import Trainer

        model_cfg = cfg_lib.tiny() if args.preset == "tiny" else cfg_lib.vigor(circular=circular)
        dataset = VIGORDataset(args.root, split=args.area, train=True,
                               pos_only=args.pos_only == "True", ori_noise=ori_noise,
                               image_dtype=args.image_dtype, grd_size=model_cfg.grd_size,
                               sat_size=model_cfg.sat_size)
        # 80/20 split with the reference's exact RNG stream
        # (train_VIGOR.py:21 np.random.seed(0); :83-91 shuffle)
        idx = np.arange(len(dataset))
        np.random.RandomState(0).shuffle(idx)
        split = int(len(idx) * 0.8)
        train_idx, val_idx = idx[:split].tolist(), idx[split:].tolist()

        trainer = Trainer(model_cfg, train_config(args), workdir=args.workdir,
                          device=args.device)
        trainer.fit(
            train_loader_fn=lambda epoch: ThreadedLoader(
                dataset, local_bs, shuffle=True, seed=epoch,
                num_workers=args.num_workers, indices=train_idx,
                shard_id=shard_id, num_shards=num_shards),
            val_loader_fn=lambda epoch: ThreadedLoader(
                dataset, local_bs, shuffle=False, num_workers=args.num_workers,
                indices=val_idx, shard_id=shard_id, num_shards=num_shards),
            meters_per_pixel=dataset.meters_per_pixel,
        )
        return trainer
    from ccvpe_tpu_torch.train.evaluate import evaluate_vigor
    return evaluate_vigor(args, ori_noise=ori_noise, circular=circular, device=args.device)


if __name__ == "__main__":
    main()
