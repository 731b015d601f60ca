"""Qualitative VIGOR results: heatmap overlay (log scale), GT/pred markers
and a quiver field of predicted orientations (the port of
scripts/visualize_vigor.py; reference
visualize_qualitative_results_VIGOR.py:120-153).

  python -m ccvpe_tpu_torch.scripts.visualize_vigor --root /data/VIGOR \
      --checkpoint model.pt --index 4 --out qualitative.png

The model runs in eval mode (train/step.py::make_eval_step) on the card,
or on `--device cpu`; rendering needs matplotlib.
"""

from __future__ import annotations

import argparse
import random

import numpy as np


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--area", default="samearea")
    p.add_argument("--checkpoint", required=True,
                   help="a reference .pt/.npz state dict, or a checkpoint directory of the "
                        "port's Trainer (its newest step)")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--ori_noise", type=float, default=180.0)
    p.add_argument("--out", default="qualitative.png")
    p.add_argument("--device", default=None,
                   help="torch device; default the card, which raises without one")
    args = p.parse_args(argv)

    import torch

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from ccvpe_tpu_torch.data.vigor import VIGORDataset
    from ccvpe_tpu_torch.models.cvm import resolve_device
    from ccvpe_tpu_torch.ops import pose
    from ccvpe_tpu_torch.train.evaluate import load_model
    from ccvpe_tpu_torch.train.step import make_eval_step
    from ccvpe_tpu_torch.utils.viz import render_qualitative

    ori_noise = 18.0 * (args.ori_noise // 18.0)
    device = resolve_device(args.device)
    dataset = VIGORDataset(args.root, split=args.area, train=False, ori_noise=ori_noise,
                           decode_device=device)
    sample = dataset.__getitem__(args.index, rng=random.Random(0))

    model_cfg = cfg_lib.vigor(ori_noise=ori_noise if ori_noise < 180 else None)
    model = load_model(model_cfg, args.checkpoint, device)
    heatmap, ori = make_eval_step(model)(torch.from_numpy(sample.grd[None]).to(device),
                                         torch.from_numpy(sample.sat[None]).to(device))
    heatmap = heatmap[0, :, :, 0].cpu().numpy()
    ori = ori[0].cpu().numpy()

    hs, ws = model_cfg.sat_size
    gt_r, gt_c = pose.gt_location(hs, ws, np.array([sample.row_offset]),
                                  np.array([sample.col_offset]))
    pr, pc = np.unravel_index(heatmap.argmax(), heatmap.shape)

    sat_img = np.clip(sample.sat * IMAGENET_STD + IMAGENET_MEAN, 0, 1)
    grd_img = np.clip(sample.grd * IMAGENET_STD + IMAGENET_MEAN, 0, 1)

    render_qualitative(grd_img, sat_img, heatmap, ori, gt_rc=(gt_r[0], gt_c[0]),
                       pred_rc=(pr, pc), out_path=args.out, angle_deg=sample.angle_deg)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
