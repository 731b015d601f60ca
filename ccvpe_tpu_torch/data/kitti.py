"""KITTI cross-view dataset: pinhole ground images and per-frame aerial
tiles (the port of ccvpe_tpu/data/kitti.py).

Reference semantics (reference datasets.py:356-638):
  * Web-Mercator metres per pixel at KITTI's latitude (datasets.py:368-372);
  * the aerial tile rotated by -heading so East = the vehicle's heading
    (datasets.py:443), then shifted by the camera-GPS lever arm
    [1.08, 0.26] m (datasets.py:366, :445-447);
  * a random (train, datasets.py:449-462) or file-given (test,
    datasets.py:584-596) shift within +-20 m and rotation within
    +-rotation_range degrees; centre crop to 512;
  * GT offsets from the shift and rotation (datasets.py:472-473), the
    orientation angle 90 - random_ori mod 360 (datasets.py:483-487).
PIL's rotate and transform(AFFINE) with bilinear resampling, as the
reference uses them.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ccvpe_tpu_torch.data.transforms import finalize, open_rgb, resize_pil

DEFAULT_LAT = 49.015           # datasets.py:358
SATMAP_ZOOM = 18               # datasets.py:359
SAT_SIZE = 512                 # datasets.py:360-361
CAMERA_GPS_SHIFT = (1.08, 0.26)  # metres, left camera (datasets.py:366)
SATMAP_DIR = "satmap"
GRD_DIR = "raw_data"
OXTS_DIR = "oxts/data"
LEFT_CAM_DIR = "image_02/data"


def meter_per_pixel(lat: float = DEFAULT_LAT, zoom: int = SATMAP_ZOOM,
                    scale: float = 1.0) -> float:
    """Web-Mercator ground resolution (datasets.py:368-372)."""
    mpp = 156543.03392 * np.cos(lat * np.pi / 180.0) / (2 ** zoom)
    mpp /= 2  # tiles fetched at scale 2
    mpp /= scale
    return mpp


@dataclass
class KittiSample:
    grd: np.ndarray
    sat: np.ndarray
    row_offset: np.float32     # = -y_offset (row = down, the GT grid's y)
    col_offset: np.float32     # = x_offset
    angle_deg: np.float32
    heading_deg: np.float32    # vehicle heading


class KittiDataset:
    """train=True: a random shift and rotation per sample; train=False: the
    shift and rotation factors of the test file's lines (file x y theta)."""

    def __init__(self, root: str, file: str, train: bool = True,
                 shift_range_lat: float = 20.0, shift_range_lon: float = 20.0,
                 rotation_range: float = 10.0,
                 grd_size: Tuple[int, int] = (256, 1024),
                 image_dtype: str = "float32"):
        # "uint8": resized pixels, normalized on the device
        self.image_dtype = image_dtype
        self.root = root
        self.train = train
        self.mpp = meter_per_pixel()
        self.shift_px_lat = shift_range_lat / self.mpp
        self.shift_px_lon = shift_range_lon / self.mpp
        self.rotation_range = rotation_range
        self.grd_size = grd_size
        with open(file) as f:
            self.lines = [l.rstrip("\n") for l in f if l.strip()]

    def __len__(self) -> int:
        return len(self.lines)

    def __getitem__(self, idx: int, rng: Optional[random.Random] = None) -> KittiSample:
        import PIL.Image
        rng = rng or random

        line = self.lines[idx]
        if self.train:
            file_name = line
            gt_shift_x = rng.uniform(-1, 1)
            gt_shift_y = rng.uniform(-1, 1)
            theta = rng.uniform(-1, 1)
        else:
            file_name, sx, sy, th = line.split(" ")
            gt_shift_x, gt_shift_y, theta = -float(sx), -float(sy), float(th)

        drive_dir, image_no = file_name[:38], file_name[38:]

        # heading from the oxts record (datasets.py:425-432)
        oxts = os.path.join(self.root, GRD_DIR, drive_dir, OXTS_DIR,
                            image_no.lower().replace(".png", ".txt"))
        with open(oxts) as f:
            heading = float(f.readline().split(" ")[5])  # radians

        # unreadable inputs degrade to blank (reference datasets.py:100-105):
        # the ground image at KITTI's raw frame size, the tile at its raw
        # size, so the affine chain holds
        grd_img = open_rgb(
            os.path.join(self.root, GRD_DIR, drive_dir, LEFT_CAM_DIR,
                         image_no.lower()), (1242, 375))
        grd = finalize(resize_pil(grd_img, self.grd_size), self.image_dtype)

        sat_map = open_rgb(os.path.join(self.root, SATMAP_DIR, file_name), (1280, 1280))

        # rotate so East = heading; lever-arm shift; random shift; random
        # rotation (datasets.py:443-464)
        sat_rot = sat_map.rotate(-heading / np.pi * 180)
        sat_align = sat_rot.transform(
            sat_rot.size, PIL.Image.AFFINE,
            (1, 0, CAMERA_GPS_SHIFT[0] / self.mpp,
             0, 1, CAMERA_GPS_SHIFT[1] / self.mpp),
            resample=PIL.Image.BILINEAR)
        sat_shift = sat_align.transform(
            sat_align.size, PIL.Image.AFFINE,
            (1, 0, gt_shift_x * self.shift_px_lon,
             0, 1, -gt_shift_y * self.shift_px_lat),
            resample=PIL.Image.BILINEAR)
        random_ori = theta * self.rotation_range
        sat_final = sat_shift.rotate(random_ori)

        # centre crop 512 (datasets.py:464, torchvision TF.center_crop)
        w, h = sat_final.size
        left, top = (w - SAT_SIZE) // 2, (h - SAT_SIZE) // 2
        sat_crop = sat_final.crop((left, top, left + SAT_SIZE, top + SAT_SIZE))
        sat = finalize(resize_pil(sat_crop, (SAT_SIZE, SAT_SIZE)), self.image_dtype)

        # GT offsets (datasets.py:472-473)
        cos_o, sin_o = np.cos(random_ori / 180 * np.pi), np.sin(random_ori / 180 * np.pi)
        x_off = int(gt_shift_x * self.shift_px_lon * cos_o
                    - gt_shift_y * self.shift_px_lat * sin_o)
        y_off = int(-gt_shift_y * self.shift_px_lat * cos_o
                    - gt_shift_x * self.shift_px_lon * sin_o)

        angle = (90.0 - random_ori) % 360.0  # datasets.py:483-487

        # GT grid convention (ops/gt.py): x = xs + col_offset, y = ys - row;
        # the reference builds y with +y_off, so row_offset = -y_off
        return KittiSample(
            grd=grd, sat=sat,
            row_offset=np.float32(-y_off), col_offset=np.float32(x_off),
            angle_deg=np.float32(angle),
            heading_deg=np.float32(heading / np.pi * 180.0),
        )

    def meters_per_pixel(self, city=None) -> float:
        return meter_per_pixel(scale=1.0)
