"""Oxford RobotCar dataset: sequential driving frames over one stitched
aerial map (the port of ccvpe_tpu/data/oxford.py).

Reference semantics (reference datasets.py:183-353):
  * one 15,966 x 18,528 stitched aerial map at 0.09240351462361521 m/px
    (datasets.py:193);
  * UTM -> pixel affine fitted by least squares to 5 control points
    (datasets.py:252-274);
  * train: a random offset crop 800^2 -> 512^2 (datasets.py:290-304);
  * val/test: the deterministic 400-px grid tiling rule (datasets.py:306-321);
  * 3 test traversals concatenated (datasets.py:217-241);
  * yaw from .npy: 'heading west, CW, radians' -> 'north-0, CW, degrees'
    (datasets.py:334-337).
The map is opened once and cropped per sample. The reference renders
y = ys + row_offset (datasets.py:327), so the row offset is negated for the
shared renderer's y = ys - row.
"""

from __future__ import annotations

import math
import os
import random
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ccvpe_tpu_torch.data.transforms import finalize, open_rgb, resize_pil

METERS_PER_PIXEL = 0.09240351462361521   # datasets.py:193
CROP = 800
OUT = 512

# UTM (easting, northing) control points -> stitched-map pixels
# (datasets.py:252-261)
_PRIMARY = np.array([
    [619400., 5736195.], [619400., 5734600.], [620795., 5736195.],
    [620795., 5734600.], [620100., 5735400.]])
_SECONDARY = np.array([
    [900., 900.], [492., 18168.], [15966., 1260.], [15553., 18528.],
    [8255., 9688.]])


def utm_to_pixel_transform():
    pad = lambda x: np.hstack([x, np.ones((x.shape[0], 1))])
    a, *_ = np.linalg.lstsq(pad(_PRIMARY), pad(_SECONDARY), rcond=None)
    return lambda x: (pad(x) @ a)[:, :-1]


@dataclass
class OxfordSample:
    grd: np.ndarray
    sat: np.ndarray
    row_offset: np.float32
    col_offset: np.float32
    angle_deg: np.float32


class OxfordDataset:
    def __init__(self, grd_image_root: str, sat_path: str, split: str = "train",
                 grd_size: Tuple[int, int] = (154, 231),
                 image_dtype: str = "float32"):
        import PIL.Image
        PIL.Image.MAX_IMAGE_PIXELS = None
        # "uint8": resized pixels, normalized on the device
        self.image_dtype = image_dtype
        self.grd_image_root = grd_image_root
        self.split = split
        self.grd_size = grd_size
        self.full_map = PIL.Image.open(sat_path)
        # decoded here: the loader's threads crop this one image at once, and
        # PIL's lazy first load() is not thread-safe
        self.full_map.load()

        def read_list(name):
            with open(os.path.join(grd_image_root, name)) as f:
                return [l.rstrip("\n").split(" ") for l in f if l.strip()]

        if split == "train":
            self.grd_list = read_list("training.txt")
            yaw_file = "train_yaw.npy"
        elif split == "val":
            self.grd_list = read_list("validation.txt")
            yaw_file = "val_yaw.npy"
        elif split == "test":
            t1 = read_list("test1_j.txt")
            t2 = read_list("test2_j.txt")
            t3 = read_list("test3_j.txt")
            self.traversal_lens = (len(t1), len(t2), len(t3))
            self.grd_list = t1 + t2 + t3
            yaw_file = "test_yaw.npy"
        else:
            raise ValueError(split)
        with open(os.path.join(grd_image_root, yaw_file), "rb") as f:
            self.yaw = np.load(f)
        arr = np.array(self.grd_list)
        self.utm = arr[:, 2:].astype(np.float64).T   # (2, N) easting/northing
        self.transform = utm_to_pixel_transform()

    def __len__(self) -> int:
        return len(self.grd_list)

    def __getitem__(self, idx: int, rng: Optional[random.Random] = None) -> OxfordSample:
        rng = rng or random

        # unreadable frames degrade to blank (reference datasets.py:100-105)
        grd_img = open_rgb(os.path.join(self.grd_image_root, self.grd_list[idx][0]),
                           (1280, 960))
        grd = finalize(resize_pil(grd_img, self.grd_size), self.image_dtype)

        coord = self.transform(
            np.array([[self.utm[0, idx], self.utm[1, idx]]]))[0]  # (col, row)

        if self.split == "train":
            # random offset crop (datasets.py:290-304)
            alpha = 2 * math.pi * rng.random()
            r = 200 * np.sqrt(2) * rng.random()
            row_off = int(r * math.cos(alpha))
            col_off = int(r * math.sin(alpha))
            crow, ccol = int(coord[1] + row_off), int(coord[0] + col_off)
            sat_img = self.full_map.crop(
                (ccol - CROP // 2, crow - CROP // 2,
                 ccol + CROP // 2, crow + CROP // 2))
            row_resized = int(np.round((CROP // 2 + row_off) / CROP * OUT - OUT // 2))
            col_resized = int(np.round((CROP // 2 + col_off) / CROP * OUT - OUT // 2))
        else:
            # deterministic grid tiling (datasets.py:306-321)
            col_split = int(coord[0] // 400)
            if np.round(coord[0] - 400 * col_split) < 200:
                col_split -= 1
            col_pixel = int(np.round(coord[0] - 400 * col_split))
            row_split = int(coord[1] // 400)
            if np.round(coord[1] - 400 * row_split) < 200:
                row_split -= 1
            row_pixel = int(np.round(coord[1] - 400 * row_split))
            sat_img = self.full_map.crop(
                (col_split * 400, row_split * 400,
                 col_split * 400 + CROP, row_split * 400 + CROP))
            row_resized = int(-(row_pixel / CROP * OUT - OUT // 2))
            col_resized = int(-(col_pixel / CROP * OUT - OUT // 2))

        sat = finalize(resize_pil(sat_img.convert("RGB"), (OUT, OUT)), self.image_dtype)

        # yaw: west-0 CW radians -> north-0 CW degrees (datasets.py:334-337)
        angle = (self.yaw[idx] / np.pi * 180.0) - 90.0
        if angle < 0:
            angle += 360.0

        return OxfordSample(
            grd=grd, sat=sat,
            row_offset=np.float32(-row_resized),   # renderer y = ys - row
            col_offset=np.float32(col_resized),
            angle_deg=np.float32(angle),
        )

    def meters_per_pixel(self, city=None) -> float:
        """Pixel on the 512 output -> metres (train_OxfordRobotCar.py:204)."""
        return METERS_PER_PIXEL / OUT * CROP
