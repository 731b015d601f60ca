"""The released-checkpoint accuracy table on the port (the port of
scripts/parity_eval.py): given dataset roots and checkpoints (reference .pt
state dicts from the reference release, or the port's Trainer checkpoint
directories), the reference-protocol table in one command:

  * VIGOR samearea / crossarea x known (ori_noise=0) / unknown
    (ori_noise=180, fixture orientations) orientation (reference
    train_VIGOR.py:246-338)
  * KITTI test1 / test2 with the longitudinal/lateral decomposition and
    recalls @1/3/5 m and deg (reference train_KITTI.py:281-432)
  * Oxford RobotCar, 3 test traversals (reference
    train_OxfordRobotCar.py:195-397)

Only the sections whose roots and checkpoints are given run. The table
prints as one block and is written as JSON to --out, with the JAX script's
sections, rows and keys.

Cross-check (--torch_check): the port's model against the PyTorch
reference model loaded from CCVPE_REFERENCE, on the same state dict and
one random batch, printing the max |heatmap delta|.

  python -m ccvpe_tpu_torch.scripts.parity_eval \
      --vigor_root /data/VIGOR \
      --vigor_samearea_ckpt models/VIGOR/samearea/model.pt \
      --kitti_root /data/KITTI --kitti_ckpt models/KITTI/model.pt \
      --kitti_test1 test1_files.txt --kitti_test2 test2_files.txt \
      --oxford_grd_root /data/Oxford/ --oxford_sat_path /data/Oxford/map.png \
      --oxford_ckpt models/Oxford/model.pt --out parity_table.json

Models run on the card, or on `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types
from types import SimpleNamespace

import numpy as np


def vigor_section(args) -> dict:
    from ccvpe_tpu_torch.train.evaluate import evaluate_vigor

    out = {}
    for area, ckpt in (("samearea", args.vigor_samearea_ckpt),
                       ("crossarea", args.vigor_crossarea_ckpt)):
        if not ckpt:
            continue
        for label, ori_noise in (("known_ori", 0.0), ("unknown_ori", 180.0)):
            ns = SimpleNamespace(root=args.vigor_root, area=area, checkpoint=ckpt,
                                 batch_size=args.batch_size, num_workers=args.num_workers,
                                 FoV=args.fov)
            print(f"== VIGOR {area} {label} (FoV {args.fov}) ==", flush=True)
            try:
                out[f"{area}/{label}"] = evaluate_vigor(ns, ori_noise=ori_noise,
                                                        circular=(args.fov == 360),
                                                        device=args.device)
            except FileNotFoundError as e:
                # the unknown-orientation protocol needs the orientation
                # fixtures (data/fixtures.py); record and go on
                print(f"skipped: {e}", flush=True)
                out[f"{area}/{label}"] = {"error": str(e)}
    return out


def kitti_section(args) -> dict:
    from ccvpe_tpu_torch.train.evaluate import evaluate_kitti

    ns = SimpleNamespace(root=args.kitti_root, checkpoint=args.kitti_ckpt,
                         test1_file=args.kitti_test1, test2_file=args.kitti_test2,
                         shift_range_lat=args.kitti_shift, shift_range_lon=args.kitti_shift,
                         rotation_range=args.kitti_rot, batch_size=args.batch_size,
                         num_workers=args.num_workers)
    print("== KITTI test1/test2 ==", flush=True)
    return evaluate_kitti(ns, device=args.device)


def oxford_section(args) -> dict:
    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.data.oxford import OxfordDataset
    from ccvpe_tpu_torch.models.cvm import resolve_device
    from ccvpe_tpu_torch.train.evaluate import load_model
    from ccvpe_tpu_torch.train.stream import stream_eval

    model_cfg = cfg_lib.oxford()
    dataset = OxfordDataset(args.oxford_grd_root, args.oxford_sat_path, split="test")
    device = resolve_device(args.device)
    model = load_model(model_cfg, args.oxford_ckpt, device)
    mpp = dataset.meters_per_pixel()
    bounds = np.cumsum((0,) + dataset.traversal_lens)
    out = {}
    for t in range(3):
        print(f"== Oxford traversal {t + 1} ==", flush=True)
        row = stream_eval(model, model_cfg, dataset, indices=range(bounds[t], bounds[t + 1]),
                          batch_size=args.batch_size, meters_per_pixel=mpp,
                          num_workers=args.num_workers, device=device)
        out[f"traversal{t + 1}"] = row
    return out


def _stub(name: str, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    sys.modules.setdefault(name, mod)
    return mod


def load_reference():
    """The reference's models module from CCVPE_REFERENCE: its heavy or
    absent imports stubbed, EfficientNet.from_pretrained made from_name, so
    nothing is downloaded (the port's own copy of
    tools/gen_golden.py::load_reference)."""
    sys.path.insert(0, os.environ.get("CCVPE_REFERENCE", "/root/reference"))
    _stub("IPython")
    _stub("IPython.display", Image=object)
    mpl = _stub("matplotlib")
    mpl.pyplot = _stub("matplotlib.pyplot")
    _stub("torchvision", models=_stub("torchvision.models"))
    _stub("torchvision.transforms")
    _stub("torchvision.utils", make_grid=object, save_image=object)
    _stub("PIL.ImageFile", LOAD_TRUNCATED_IMAGES=True)
    try:
        import PIL  # noqa: F401
    except Exception:
        _stub("PIL", ImageFile=sys.modules["PIL.ImageFile"])
    try:
        import torch.utils.tensorboard  # noqa: F401
    except Exception:
        sys.modules["torch.utils.tensorboard"] = _stub("torch.utils.tensorboard",
                                                       SummaryWriter=object)

    from efficientnet_pytorch.model import EfficientNet

    EfficientNet.from_pretrained = classmethod(
        lambda cls, name, circular=False, **kw: cls.from_name(name, circular))
    import models as ref_models
    return ref_models


def torch_check(model_cfg_name: str, checkpoint: str, device=None) -> dict:
    """The port's model and the reference model on the same state dict and
    one random batch of numpy seed 0: the max |heatmap delta|."""
    import torch

    from ccvpe_tpu_torch.core import config as cfg_lib
    from ccvpe_tpu_torch.models.cvm import resolve_device
    from ccvpe_tpu_torch.train.evaluate import load_model
    from ccvpe_tpu_torch.train.step import make_eval_step

    ref_models = load_reference()
    model_cfg = getattr(cfg_lib, model_cfg_name)()
    device = resolve_device(device)
    model = load_model(model_cfg, checkpoint, device)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if model_cfg_name == "vigor":
        ref = ref_models.CVM_VIGOR("cpu", circular_padding=True)
    elif model_cfg_name == "kitti":
        ref = ref_models.CVM_KITTI("cpu")
    else:
        ref = ref_models.CVM_OxfordRobotCar("cpu")
    ref.load_state_dict(sd)
    ref.eval()

    rng = np.random.default_rng(0)
    hg, wg = model_cfg.grd_size
    hs, ws = model_cfg.sat_size
    grd = rng.normal(size=(1, hg, wg, 3)).astype(np.float32)
    sat = rng.normal(size=(1, hs, ws, 3)).astype(np.float32)
    heat_port, _ = make_eval_step(model)(torch.from_numpy(grd).to(device),
                                         torch.from_numpy(sat).to(device))
    with torch.no_grad():
        _, heat_ref, *_ = ref(torch.from_numpy(grd).permute(0, 3, 1, 2),
                              torch.from_numpy(sat).permute(0, 3, 1, 2))
    delta = float(np.abs(heat_port.cpu().numpy()[..., 0] - heat_ref.numpy()[:, 0]).max())
    print(f"torch cross-check ({model_cfg_name}): max |heatmap delta| = {delta:.2e}", flush=True)
    return {"max_heatmap_delta": delta}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vigor_root")
    p.add_argument("--vigor_samearea_ckpt")
    p.add_argument("--vigor_crossarea_ckpt")
    p.add_argument("--fov", type=int, default=360)
    p.add_argument("--kitti_root")
    p.add_argument("--kitti_ckpt")
    p.add_argument("--kitti_test1")
    p.add_argument("--kitti_test2")
    p.add_argument("--kitti_shift", type=float, default=20.0)
    p.add_argument("--kitti_rot", type=float, default=10.0)
    p.add_argument("--oxford_grd_root")
    p.add_argument("--oxford_sat_path")
    p.add_argument("--oxford_ckpt")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--out", default="parity_table.json")
    p.add_argument("--torch_check", action="store_true",
                   help="diff one forward of the port's model against the torch reference "
                        "model on the same weights")
    p.add_argument("--device", default=None,
                   help="torch device; default the card, which raises without one")
    args = p.parse_args(argv)

    table = {}
    if args.vigor_root:
        table["vigor"] = vigor_section(args)
        if args.torch_check and args.vigor_samearea_ckpt:
            table["vigor"]["torch_check"] = torch_check("vigor", args.vigor_samearea_ckpt,
                                                        args.device)
    if args.kitti_root:
        table["kitti"] = kitti_section(args)
        if args.torch_check and args.kitti_ckpt:
            table["kitti"]["torch_check"] = torch_check("kitti", args.kitti_ckpt, args.device)
    if args.oxford_grd_root:
        table["oxford"] = oxford_section(args)
        if args.torch_check and args.oxford_ckpt:
            table["oxford"]["torch_check"] = torch_check("oxford", args.oxford_ckpt,
                                                         args.device)
    if not table:
        p.error("no section selected - pass at least one dataset root")

    print("\n================ PARITY TABLE ================")
    for section, rows in table.items():
        for row, metrics in rows.items():
            if not isinstance(metrics, dict):
                continue
            cells = " ".join(f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, float))
            print(f"{section:8s} {row:24s} {cells}")
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {args.out}")
    return table


if __name__ == "__main__":
    main()
