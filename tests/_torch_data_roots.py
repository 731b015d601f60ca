"""Synthetic dataset roots for the port's data and evaluation tests: the
VIGOR, KITTI and Oxford directory layouts of tests/test_datasets.py
(reference datasets.py), filled with seeded noise images so that rolls,
crops and resizes move real content."""

import os

import numpy as np
import pytest

PIL = pytest.importorskip("PIL")
import PIL.Image  # noqa: E402

KITTI_DRIVE = "2011_09_26/2011_09_26_drive_0001_sync/"


def noise_image(path, size_wh, seed, fmt=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = size_wh
    PIL.Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path, fmt)


def vigor_root(root: str) -> str:
    """4 cities x 3 aerial patches (640^2 PNG) x 4 panoramas (1024 x 512
    JPEG), each panorama with 4 references and pixel deltas, of which some
    semi-positives fall outside the patch."""
    seed = 0
    for city in ("NewYork", "Seattle", "SanFrancisco", "Chicago"):
        sats = [f"sat_{city}_{i}.png" for i in range(3)]
        split_dir = os.path.join(root, "splits_new", city)
        os.makedirs(split_dir, exist_ok=True)
        with open(os.path.join(split_dir, "satellite_list.txt"), "w") as f:
            f.write("\n".join(sats) + "\n")
        for s in sats:
            seed += 1
            noise_image(os.path.join(root, city, "satellite", s), (640, 640), seed)
        lines = []
        for i in range(4):
            pano = f"pano_{city}_{i}.jpg"
            seed += 1
            noise_image(os.path.join(root, city, "panorama", pano), (1024, 512), seed)
            fields = [pano]
            for j in range(4):
                row = 10.0 + 7 * i - 150 * j
                col = -20.0 + 11 * j + 40 * i
                fields += [sats[(i + j) % 3], str(row), str(col)]
            lines.append(" ".join(fields))
        for tag in ("same_area_balanced_train.txt", "same_area_balanced_test.txt",
                    "pano_label_balanced.txt"):
            with open(os.path.join(split_dir, tag), "w") as f:
                f.write("\n".join(lines) + "\n")
    return root


def kitti_root(root: str):
    """Two frames of one drive (satellite tile 1280^2, camera frame 1242 x
    375, oxts headings), a train file and two test files of shifted and
    rotated lines. Returns (root, train_file, test1_file, test2_file)."""
    names = []
    for k in range(2):
        fname = KITTI_DRIVE + f"000000000{k}.png"
        names.append(fname)
        noise_image(os.path.join(root, "satmap", fname), (1280, 1280), 100 + k)
        noise_image(os.path.join(root, "raw_data", KITTI_DRIVE, f"image_02/data/000000000{k}.png"),
                    (1242, 375), 200 + k)
        oxts = os.path.join(root, "raw_data", KITTI_DRIVE, f"oxts/data/000000000{k}.txt")
        os.makedirs(os.path.dirname(oxts), exist_ok=True)
        with open(oxts, "w") as f:
            f.write(f"49.0 8.4 112.9 0.01 0.02 {0.3 + 1.1 * k} rest\n")
    train_file = os.path.join(root, "train.txt")
    with open(train_file, "w") as f:
        f.write("\n".join(names * 3) + "\n")
    rng = np.random.default_rng(5)
    files = []
    for t, n in (("test1", 5), ("test2", 3)):
        path = os.path.join(root, f"{t}.txt")
        with open(path, "w") as f:
            for i in range(n):
                sx, sy, th = rng.uniform(-1, 1, 3)
                f.write(f"{names[i % 2]} {sx:.4f} {sy:.4f} {th:.4f}\n")
        files.append(path)
    return (root, train_file, *files)


def oxford_root(root: str):
    """A 2000^2 stitched map, frames at UTM points near the first control
    point (map pixel 900, 900), the train/val lists and three test
    traversals with one yaw per frame over all three. Returns (root/,
    map path)."""
    sat_path = os.path.join(root, "map.png")
    noise_image(sat_path, (2000, 2000), 300)
    rng = np.random.default_rng(7)
    lines = []
    for i in range(4):
        rel = f"frames/f{i}.png"
        noise_image(os.path.join(root, rel), (1280, 960), 400 + i)
        e, n = 619400.0 + rng.uniform(0, 60), 5736195.0 - rng.uniform(0, 60)
        lines.append(f"{rel} x {e:.3f} {n:.3f}")
    for name, sel in (("training.txt", lines), ("validation.txt", lines[:2]),
                      ("test1_j.txt", lines[:2]), ("test2_j.txt", lines[2:3]),
                      ("test3_j.txt", lines[3:])):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(sel) + "\n")
    for name, n in (("train_yaw.npy", 4), ("val_yaw.npy", 2), ("test_yaw.npy", 4)):
        np.save(os.path.join(root, name), rng.uniform(-np.pi, np.pi, n))
    return root + "/", sat_path
