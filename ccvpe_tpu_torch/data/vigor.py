"""VIGOR dataset: ground panoramas of four cities and their aerial patches
(the port of ccvpe_tpu/data/vigor.py).

Reference semantics (reference datasets.py:18-177): samearea/crossarea
splits, per panorama 1 positive + 3 semi-positive aerial references with
pixel deltas, a random panorama roll as orientation augmentation, fixed
test orientations from the .npy fixtures. Samples carry images and the
(row_offset, col_offset, angle_deg) scalars; the GT maps are rendered on the
device from them (ops/gt.py)."""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ccvpe_tpu_torch.data.transforms import load_image, normalize, open_rgb, resize_pil

CITIES_SAME = ("NewYork", "Seattle", "SanFrancisco", "Chicago")
CITIES_CROSS_TRAIN = ("NewYork", "Seattle")
CITIES_CROSS_TEST = ("SanFrancisco", "Chicago")

# metres per pixel of the raw 640-px aerial patches per city
# (train_VIGOR.py:193-200)
METER_PER_PIXEL = {
    "NewYork": 0.113248,
    "Seattle": 0.100817,
    "SanFrancisco": 0.118141,
    "Chicago": 0.111262,
}


@dataclass
class VigorSample:
    grd: np.ndarray          # [Hg, Wg, 3] float32 or uint8
    sat: np.ndarray          # [Hs, Ws, 3] float32 or uint8
    row_offset: np.float32
    col_offset: np.float32
    angle_deg: np.float32
    city: str


class VIGORDataset:
    """Index-based; __getitem__ is thread-safe given a per-call rng."""

    def __init__(
        self,
        root: str,
        split: str = "samearea",
        train: bool = True,
        pos_only: bool = True,
        ori_noise: float = 180.0,
        random_orientation: Optional[np.ndarray] = None,
        label_root: str = "splits_new",
        grd_size: Tuple[int, int] = (320, 640),
        sat_size: Tuple[int, int] = (512, 512),
        image_dtype: str = "float32",
        decode_device=None,
    ):
        self.root = root
        self.split = split
        self.train = train
        self.pos_only = pos_only
        self.ori_noise = ori_noise
        self.random_orientation = random_orientation
        self.grd_size = grd_size
        self.sat_size = sat_size
        # "uint8": resized pixels, normalized on the device
        self.image_dtype = image_dtype
        # where the panoramas decode (transforms.load_image): None PIL, else
        # data/native_io.py on that device (a card's index fixed here, on
        # the constructing thread)
        if decode_device is not None:
            from ccvpe_tpu_torch.data.native_io import resolve
            decode_device = resolve(decode_device)
        self.decode_device = decode_device

        if split == "samearea":
            cities = CITIES_SAME
        elif split == "crossarea":
            cities = CITIES_CROSS_TRAIN if train else CITIES_CROSS_TEST
        else:
            raise ValueError(split)

        # aerial list + index (datasets.py:40-55)
        self.sat_list = []
        sat_index = {}
        for city in cities:
            fname = os.path.join(root, label_root, city, "satellite_list.txt")
            with open(fname) as f:
                for line in f:
                    name = line.strip()
                    if not name:
                        continue
                    sat_index[name] = len(self.sat_list)
                    self.sat_list.append(os.path.join(root, city, "satellite", name))

        # panorama list + labels + deltas (datasets.py:57-93)
        self.grd_list = []
        self.label = []
        self.delta = []
        self.city_of = []
        for city in cities:
            if split == "samearea":
                tag = "same_area_balanced_train.txt" if train else "same_area_balanced_test.txt"
            else:
                tag = "pano_label_balanced.txt"
            with open(os.path.join(root, label_root, city, tag)) as f:
                for line in f:
                    data = np.array(line.split(" "))
                    label = np.array([sat_index[data[i]] for i in (1, 4, 7, 10)], int)
                    delta = np.array(
                        [data[2:4], data[5:7], data[8:10], data[11:13]], float)
                    self.grd_list.append(os.path.join(root, city, "panorama", data[0]))
                    self.label.append(label)
                    self.delta.append(delta)
                    self.city_of.append(city)
        self.label = np.array(self.label)
        self.delta = np.array(self.delta)

    def __len__(self) -> int:
        return len(self.grd_list)

    def __getitem__(self, idx: int, rng: Optional[random.Random] = None) -> VigorSample:
        rng = rng or random
        grd = load_image(self.grd_list[idx], self.grd_size, dtype=self.image_dtype,
                         decode_device=self.decode_device)

        # orientation: a random panorama roll (datasets.py:109-118)
        if self.random_orientation is None:
            if self.ori_noise >= 180:
                rotation = rng.uniform(0.0, 1.0)
            else:
                r = self.ori_noise / 360.0
                rotation = rng.uniform(-r, r)
        else:
            rotation = float(self.random_orientation[idx]) / 360.0
        shift = int(round(rotation * grd.shape[1]))
        grd = np.roll(grd, shift, axis=1)
        angle = rotation * 360.0  # 0 = North, counter-clockwise (datasets.py:120)

        # aerial patch: the positive, or a random one among positive and
        # semi-positives whose GT lies inside the patch (datasets.py:123-133)
        if self.pos_only:
            pos_index = 0
        else:
            while True:
                pos_index = rng.randint(0, 3)
                row_off, col_off = self.delta[idx, pos_index]
                if abs(row_off) < 320 and abs(col_off) < 320:
                    break
        row_off, col_off = self.delta[idx, pos_index]
        # an unreadable patch degrades to blank at the raw 640-px size, so
        # the delta rescale below stays sane
        sat_img = open_rgb(self.sat_list[self.label[idx][pos_index]], (640, 640))
        w_raw, h_raw = sat_img.size
        sat_resized = resize_pil(sat_img, self.sat_size)
        sat = (np.asarray(sat_resized, np.uint8)
               if self.image_dtype == "uint8" else normalize(sat_resized))
        # deltas rescaled to the resized patch (datasets.py:139-141)
        row_off = np.round(row_off / h_raw * self.sat_size[0])
        col_off = np.round(col_off / w_raw * self.sat_size[1])

        return VigorSample(
            grd=grd, sat=sat,
            row_offset=np.float32(row_off), col_offset=np.float32(col_off),
            angle_deg=np.float32(angle % 360.0),
            city=self.city_of[idx],
        )

    def meters_per_pixel(self, city: str) -> float:
        """Pixel -> metre factor on the resized patch (train_VIGOR.py:193-200:
        raw m/px / 512 * 640)."""
        return METER_PER_PIXEL[city] / self.sat_size[0] * 640.0
