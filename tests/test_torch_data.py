"""Port vs JAX: the data layer. On synthetic VIGOR, KITTI and Oxford roots
(tests/_torch_data_roots.py), each port dataset gives the same arrays
(np.array_equal, same dtype) and the same scalars as the JAX class for the
same index and random.Random seed; the transforms agree; a corrupt image
degrades to the same blank in both; the orientation fixture is the JAX one.
The JAX side reads images through PIL (CCVPE_NATIVE_IO=0), as the port
does."""

import dataclasses
import logging
import random
import shutil

import numpy as np
import pytest

import _torch_data_roots as roots
from ccvpe_tpu.data import fixtures as jfixtures
from ccvpe_tpu.data import kitti as jkitti
from ccvpe_tpu.data import oxford as joxford
from ccvpe_tpu.data import transforms as jtransforms
from ccvpe_tpu.data import vigor as jvigor
from ccvpe_tpu_torch.data import fixtures, kitti, oxford, transforms, vigor


@pytest.fixture(autouse=True)
def pil_on_the_jax_side(monkeypatch):
    monkeypatch.setenv("CCVPE_NATIVE_IO", "0")


@pytest.fixture(scope="module")
def vigor_dir(tmp_path_factory):
    return roots.vigor_root(str(tmp_path_factory.mktemp("vigor")))


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    return roots.kitti_root(str(tmp_path_factory.mktemp("kitti")))


@pytest.fixture(scope="module")
def oxford_dir(tmp_path_factory):
    return roots.oxford_root(str(tmp_path_factory.mktemp("oxford")))


def assert_same_sample(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, str):
            assert x == y, f.name
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            assert np.array_equal(x, y), f.name


def assert_same_items(port_ds, jax_ds, indices, seed):
    assert len(port_ds) == len(jax_ds)
    for i in indices:
        assert_same_sample(port_ds.__getitem__(i, rng=random.Random(f"{seed}/{i}")),
                           jax_ds.__getitem__(i, rng=random.Random(f"{seed}/{i}")))


ORIENTATION = np.linspace(0.0, 359.0, 16)
# name -> VIGORDataset kwargs
VIGOR_CASES = {
    "samearea train roll": dict(split="samearea", train=True),
    "samearea train uint8": dict(split="samearea", train=True, image_dtype="uint8"),
    "semi-positives": dict(split="samearea", train=True, pos_only=False),
    "ori noise 45": dict(split="samearea", train=True, ori_noise=45.0),
    "samearea test fixed orientation": dict(split="samearea", train=False,
                                            random_orientation=ORIENTATION),
    "crossarea train": dict(split="crossarea", train=True),
    "crossarea test uint8": dict(split="crossarea", train=False, image_dtype="uint8"),
    "small sizes": dict(split="samearea", train=False, grd_size=(64, 128),
                        sat_size=(128, 128)),
}


@pytest.mark.parametrize("case", list(VIGOR_CASES))
def test_vigor_matches_jax(vigor_dir, case):
    kw = VIGOR_CASES[case]
    port = vigor.VIGORDataset(vigor_dir, **kw)
    ref = jvigor.VIGORDataset(vigor_dir, **kw)
    assert port.grd_list == ref.grd_list and port.sat_list == ref.sat_list
    assert port.city_of == ref.city_of
    assert np.array_equal(port.label, ref.label) and np.array_equal(port.delta, ref.delta)
    assert_same_items(port, ref, range(0, len(port), 3), seed=case)
    for city in set(port.city_of):
        assert port.meters_per_pixel(city) == ref.meters_per_pixel(city)


def test_vigor_semi_positives_pick_several_patches(vigor_dir):
    ds = vigor.VIGORDataset(vigor_dir, split="samearea", train=True, pos_only=False)
    offsets = {(float(s.row_offset), float(s.col_offset))
               for s in (ds.__getitem__(1, rng=random.Random(t)) for t in range(12))}
    assert len(offsets) >= 2
    assert all(abs(r) < 320 and abs(c) < 320 for r, c in offsets)


KITTI_CASES = {"train": (1, True, "float32"), "test1": (2, False, "float32"),
               "test2 uint8": (3, False, "uint8"), "train uint8": (1, True, "uint8")}


@pytest.mark.parametrize("case", list(KITTI_CASES))
def test_kitti_matches_jax(kitti_dir, case):
    which, train, dtype = KITTI_CASES[case]
    root, file = kitti_dir[0], kitti_dir[which]
    kw = dict(train=train, rotation_range=10.0, image_dtype=dtype)
    port, ref = kitti.KittiDataset(root, file, **kw), jkitti.KittiDataset(root, file, **kw)
    assert_same_items(port, ref, range(len(port)), seed=case)
    assert port.meters_per_pixel() == ref.meters_per_pixel() == jkitti.meter_per_pixel()


OXFORD_CASES = {"train": ("train", "float32"), "val uint8": ("val", "uint8"),
                "test": ("test", "float32")}


@pytest.mark.parametrize("case", list(OXFORD_CASES))
def test_oxford_matches_jax(oxford_dir, case):
    split, dtype = OXFORD_CASES[case]
    port = oxford.OxfordDataset(*oxford_dir, split=split, image_dtype=dtype)
    ref = joxford.OxfordDataset(*oxford_dir, split=split, image_dtype=dtype)
    assert np.array_equal(port.utm, ref.utm) and np.array_equal(port.yaw, ref.yaw)
    if split == "test":
        assert port.traversal_lens == ref.traversal_lens == (2, 1, 1)
    assert_same_items(port, ref, range(len(port)), seed=case)
    assert port.meters_per_pixel() == ref.meters_per_pixel()
    pts = np.array([[619400.0, 5736195.0], [620100.0, 5735400.0]])
    np.testing.assert_array_equal(oxford.utm_to_pixel_transform()(pts),
                                  joxford.utm_to_pixel_transform()(pts))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_load_image_matches_jax(vigor_dir, dtype):
    path = vigor.VIGORDataset(vigor_dir).grd_list[2]
    for size, fallback in (((320, 640), None), ((37, 91), (50, 60))):
        got = transforms.load_image(path, size, fallback, dtype=dtype)
        want = jtransforms.load_image(path, size, fallback, dtype=dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(transforms.IMAGENET_MEAN, jtransforms.IMAGENET_MEAN)
    np.testing.assert_array_equal(transforms.IMAGENET_STD, jtransforms.IMAGENET_STD)


def test_corrupt_image_degrades_to_the_same_blank(vigor_dir, tmp_path, caplog):
    root = shutil.copytree(vigor_dir, tmp_path / "vigor")
    port = vigor.VIGORDataset(str(root), split="samearea", train=True)
    ref = jvigor.VIGORDataset(str(root), split="samearea", train=True)
    with open(port.grd_list[1], "wb") as f:
        f.write(b"not a jpeg")
    with open(port.sat_list[int(port.label[2][0])], "wb") as f:
        f.write(b"\xff\xd8broken")
    with caplog.at_level(logging.WARNING, logger="ccvpe_tpu_torch.data"):
        assert_same_items(port, ref, (1, 2), seed="corrupt")
    assert sum("unreadable image" in r.message and r.name == "ccvpe_tpu_torch.data"
               for r in caplog.records) == 2
    blank = port.__getitem__(1, rng=random.Random(0)).grd
    assert blank.shape == (320, 640, 3)
    np.testing.assert_array_equal(blank, np.broadcast_to(transforms.normalize(
        np.zeros((1, 1, 3), np.uint8)), blank.shape))


@pytest.mark.parametrize("area", ["samearea", "crossarea"])
def test_orientation_fixture_matches_jax(monkeypatch, tmp_path, area):
    monkeypatch.setenv("CCVPE_REFERENCE", str(tmp_path))   # no reference mount
    got, want = fixtures.load_orientation_fixture(area), jfixtures.load_orientation_fixture(area)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_orientation_fixture_refusals(monkeypatch, tmp_path):
    monkeypatch.setenv("CCVPE_REFERENCE", str(tmp_path))
    np.save(tmp_path / "samearea_orientation_test.npy", np.arange(3.0))
    np.testing.assert_array_equal(fixtures.load_orientation_fixture("samearea"), np.arange(3.0))
    monkeypatch.setattr(fixtures, "_ASSET", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError):
        fixtures.load_orientation_fixture("crossarea")
    with pytest.raises(ValueError):
        fixtures.load_orientation_fixture("bogus")
