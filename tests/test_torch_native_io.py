"""Port vs JAX: the image ingest (ccvpe_tpu_torch/data/native_io.py and
ops/resize_cuda.py against ccvpe_tpu/data/native_io.py, native/io.cc and the
JAX PIL path) on the CPU, where the port takes its plain version: PIL's
decode, then resize_plain, the card's kernels' arithmetic in torch.

Files are written by PIL from numpy seeds: a smooth synthetic panorama at
VIGOR's 2048 x 1024 and noise patches, as JPEG (baseline 4:2:0, 4:4:4,
progressive, grayscale) and PNG (RGB, RGBA, palette). Tolerances:
- against JAX's PIL path (CCVPE_NATIVE_IO=0): uint8 within 1 LSB (Pillow
  rounds its first pass to uint8 and resamples in fixed point, io.cc keeps
  float rows), float32 within 1/(255 * std) + 1e-6, that LSB normalized by
  each channel's std (0.229, 0.224, 0.225: in green an LSB is 0.017507);
- against JAX's native library (native/io.cc, where it builds): uint8
  within 1 LSB (io.cc built with -O3 -march=native may fuse a tap's
  product and add; the port rounds each), float32 within 1e-5.
"""

import logging
import random

import numpy as np
import pytest
import torch

import _torch_data_roots as roots
from _torch_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from ccvpe_tpu.data import native_io as jnative
from ccvpe_tpu.data import transforms as jtransforms
from ccvpe_tpu.data import vigor as jvigor
from ccvpe_tpu_torch.csrc import build
from ccvpe_tpu_torch.data import native_io, transforms, vigor
from ccvpe_tpu_torch.ops import resize_cuda

PIL = pytest.importorskip("PIL")
import PIL.Image  # noqa: E402

U8_ATOL = 1
PIL_F32_ATOL = 1.0 / (255 * jtransforms.IMAGENET_STD.astype(np.float64)) + 1e-6   # per channel
NATIVE_F32_ATOL = 1e-5
VIGOR_IN, VIGOR_OUT = (1024, 2048), (320, 640)


def smooth_panorama(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.stack([128 + 100 * np.sin(xx / 97.0 + yy / 211.0),
                     128 + 90 * np.cos(xx / 53.0) * np.sin(yy / 71.0),
                     128 + 80 * np.sin(yy / 37.0 + xx / 301.0)], -1).astype(np.uint8)


# name -> (PIL mode to save, save kwargs, extension)
FORMATS = {
    "jpeg 4:2:0": ("RGB", dict(quality=90), "jpg"),
    "jpeg 4:4:4": ("RGB", dict(quality=90, subsampling=0), "jpg"),
    "jpeg progressive": ("RGB", dict(quality=85, progressive=True), "jpg"),
    "jpeg gray": ("L", dict(quality=90), "jpg"),
    "png rgb": ("RGB", {}, "png"),
    "png rgba": ("RGBA", {}, "png"),
    "png palette": ("P", {}, "png"),
}
# (image, input (h, w), output (h, w)): integer and non-integer downscales,
# an upscale, VIGOR's panorama shape
SIZES = {
    "pano to vigor": ("smooth", VIGOR_IN, VIGOR_OUT),
    "noise /4": ("noise", (96, 160), (24, 40)),
    "noise non-integer": ("noise", (96, 160), (37, 91)),
    "noise up": ("noise", (40, 56), (75, 130)),
}
CASES = [(f, s) for f in FORMATS for s in SIZES
         if s != "pano to vigor" or f in ("jpeg 4:2:0", "png rgb")]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(format, size case): path} of PIL-written files."""
    root = tmp_path_factory.mktemp("ingest")
    rng = np.random.default_rng(19)
    images = {"smooth": smooth_panorama(*VIGOR_IN)}
    out = {}
    for fmt, size in CASES:
        what, (h, w), _ = SIZES[size]
        key = (what, h, w)
        if key not in images:
            images[key] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        pixels = images["smooth" if what == "smooth" else key]
        mode, kw, ext = FORMATS[fmt]
        img = PIL.Image.fromarray(pixels)
        if mode == "L":
            img = img.convert("L")
        elif mode == "RGBA":
            alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
            img = PIL.Image.fromarray(np.dstack([pixels, alpha]), "RGBA")
        elif mode == "P":
            img = img.quantize(64)
        name = "_".join("".join(c if c.isalnum() else "_" for c in t) for t in (fmt, size))
        path = str(root / f"{name}.{ext}")
        img.save(path, **kw)
        out[fmt, size] = path
    return out


@pytest.fixture
def pil_jax(monkeypatch):
    """JAX's load_image on its PIL path."""
    monkeypatch.setenv("CCVPE_NATIVE_IO", "0")


def max_diff(a, b):
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def channel_diff(a, b):
    """The largest difference in each channel."""
    return np.abs(a.astype(np.float64) - b.astype(np.float64)).reshape(-1, 3).max(0)


@pytest.mark.parametrize("fmt,size", CASES)
def test_plain_ingest_matches_jax_pil_path(files, fmt, size, pil_jax):
    path, out_hw = files[fmt, size], SIZES[size][2]
    raw = native_io.load_image_raw_native(path, out_hw, device="cpu")
    want = jtransforms.load_image(path, out_hw, dtype="uint8")
    assert raw.dtype == np.uint8 and raw.shape == want.shape == (*out_hw, 3)
    assert max_diff(raw, want) <= U8_ATOL
    norm = native_io.load_image_native(path, out_hw, device="cpu")
    want = jtransforms.load_image(path, out_hw, dtype="float32")
    assert norm.dtype == np.float32 and norm.shape == want.shape
    assert (channel_diff(norm, want) <= PIL_F32_ATOL).all()


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.skip("native/io.cc does not build here (no libjpeg or libpng headers)")
    return jnative


@pytest.mark.parametrize("fmt,size", CASES)
def test_plain_ingest_matches_jax_native_library(files, fmt, size, jax_native):
    path, out_hw = files[fmt, size], SIZES[size][2]
    raw = native_io.load_image_raw_native(path, out_hw, device="cpu")
    assert max_diff(raw, jax_native.load_image_raw_native(path, out_hw)) <= U8_ATOL
    norm = native_io.load_image_native(path, out_hw, device="cpu")
    assert max_diff(norm, jax_native.load_image_native(path, out_hw)) <= NATIVE_F32_ATOL


def test_load_batch_matches_jax_native_library(files, jax_native):
    """A batch of two sizes (the plain version reads them with 3 threads)."""
    paths = [files[f, "noise non-integer"] for f in ("jpeg 4:2:0", "png rgba", "jpeg gray")]
    paths.append(files["jpeg 4:4:4", "noise up"])
    got = native_io.load_batch_native(paths, (37, 91), num_threads=3, device="cpu")
    want = jax_native.load_batch_native(paths, (37, 91), num_threads=3)
    assert got.shape == want.shape == (4, 37, 91, 3) and got.dtype == np.float32
    assert max_diff(got, want) <= NATIVE_F32_ATOL
    one = [native_io.load_image_native(p, (37, 91), device="cpu") for p in paths]
    np.testing.assert_array_equal(got, np.stack(one))


def pillow_weights(in_size, out_size):
    """Pillow's ImagingPrecompute (src/libImaging/Resample.c) for its
    triangle filter, in float64: ss = 1 / filterscale multiplies."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first, taps = np.zeros(out_size, int), np.zeros(out_size, int)
    w = np.zeros((out_size, ksize))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        for x in range(hi - lo):
            w[xx, x] = max(0.0, 1.0 - abs((x + lo - center + 0.5) * ss))
        w[xx] /= w[xx].sum()
        first[xx], taps[xx] = lo, hi - lo
    return first, taps, w


@pytest.mark.parametrize("in_size,out_size", [(2048, 640), (1024, 320), (160, 40), (160, 91),
                                              (56, 130), (7, 7), (1, 5)])
def test_contributions_are_pillows(in_size, out_size):
    first, taps, w = resize_cuda.contributions(in_size, out_size)
    want_first, want_taps, want = pillow_weights(in_size, out_size)
    np.testing.assert_array_equal(first, want_first)
    np.testing.assert_array_equal(taps, want_taps)
    np.testing.assert_allclose(w, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=0, atol=1e-12)
    assert (w[np.arange(w.shape[1]) >= taps[:, None]] == 0).all()


def test_resize_plain_batch_and_cpu_dispatch():
    """A batch gives each image's result; resize() on a CPU tensor is the
    plain version; the float path is the normalize of io.cc's constants."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (3, 30, 50, 3), dtype=np.uint8))
    batch = resize_cuda.resize(x, (11, 17))
    assert batch.dtype == torch.uint8 and batch.shape == (3, 11, 17, 3)
    for i in range(3):
        assert torch.equal(batch[i], resize_cuda.resize_plain(x[i], (11, 17)))
    mean, std = transforms.IMAGENET_MEAN, transforms.IMAGENET_STD
    f = resize_cuda.resize(x, (11, 17), mean, std)
    bias, inv = resize_cuda.normalize_constants(mean, std)
    assert bias.dtype == inv.dtype == np.float32
    u8 = batch.double().numpy()
    np.testing.assert_allclose(f.numpy(), (u8 - 255 * mean) / 255 / std, rtol=0,
                               atol=0.5 / (255 * 0.225) + 1e-5)
    with pytest.raises(ValueError):
        resize_cuda.resize(x.float(), (11, 17))


@pytest.mark.parametrize("content", [b"not an image at all", b"\xff\xd8\xff broken jpeg",
                                     b"\x89PNG\r\n\x1a\n broken png"])
def test_corrupt_and_non_image_files_give_jaxs_blank(tmp_path, content, pil_jax, caplog):
    path = str(tmp_path / "bad.jpg")
    with open(path, "wb") as f:
        f.write(content)
    assert native_io.load_image_raw_native(path, (8, 12), device="cpu") is None
    assert native_io.load_image_native(path, (8, 12), device="cpu") is None
    assert native_io.load_batch_native([path], (8, 12), device="cpu") is None
    assert native_io.load_image_native(str(tmp_path / "missing.jpg"), (8, 12), device="cpu") is None
    for dtype in ("uint8", "float32"):
        with caplog.at_level(logging.WARNING, logger="ccvpe_tpu_torch.data"):
            got = transforms.load_image(path, (8, 12), (5, 6), dtype=dtype, decode_device="cpu")
        want = jtransforms.load_image(path, (8, 12), (5, 6), dtype=dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sum("unreadable image" in r.message and r.name == "ccvpe_tpu_torch.data"
               for r in caplog.records) == 2


@pytest.fixture(scope="module")
def vigor_dir(tmp_path_factory):
    return roots.vigor_root(str(tmp_path_factory.mktemp("vigor")))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_vigor_decoded_on_the_plain_path_matches_jax(vigor_dir, dtype, jax_native, monkeypatch):
    """VIGORDataset(decode_device="cpu") against JAX's, which takes
    native/io.cc for its panoramas: the panoramas within io.cc's
    tolerances, the aerial patches (PIL in both) and scalars the same."""
    monkeypatch.delenv("CCVPE_NATIVE_IO", raising=False)
    kw = dict(split="samearea", train=True, image_dtype=dtype)
    port = vigor.VIGORDataset(vigor_dir, decode_device="cpu", **kw)
    ref = jvigor.VIGORDataset(vigor_dir, **kw)
    for i in range(0, len(port), 5):
        a = port.__getitem__(i, rng=random.Random(f"ingest/{i}"))
        b = ref.__getitem__(i, rng=random.Random(f"ingest/{i}"))
        assert a.grd.dtype == b.grd.dtype and a.grd.shape == b.grd.shape
        assert max_diff(a.grd, b.grd) <= (U8_ATOL if dtype == "uint8" else NATIVE_F32_ATOL)
        assert np.array_equal(a.sat, b.sat) and a.city == b.city
        assert (a.row_offset, a.col_offset, a.angle_deg) == (b.row_offset, b.col_offset,
                                                            b.angle_deg)


def test_no_decode_device_keeps_pil(vigor_dir, monkeypatch):
    """decode_device=None reads with PIL as before, whatever
    CCVPE_NATIVE_IO says; CCVPE_NATIVE_IO=0 refuses the native path."""
    path = vigor.VIGORDataset(vigor_dir).grd_list[1]
    monkeypatch.delenv("CCVPE_NATIVE_IO", raising=False)
    monkeypatch.setattr(native_io, "_decode_resize", lambda *a, **k: pytest.fail("native path"))
    got = transforms.load_image(path, (37, 91), dtype="uint8")
    monkeypatch.setenv("CCVPE_NATIVE_IO", "0")
    assert np.array_equal(got, jtransforms.load_image(path, (37, 91), dtype="uint8"))
    assert np.array_equal(transforms.load_image(path, (37, 91), dtype="uint8",
                                                decode_device="cpu"), got)
    assert vigor.VIGORDataset(vigor_dir).decode_device is None


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "x.png")
    PIL.Image.new("RGB", (4, 4)).save(path)
    for call in (lambda: native_io.load_image_native(path, (2, 2)),
                 lambda: native_io.load_image_raw_native(path, (2, 2)),
                 lambda: native_io.load_batch_native([path], (2, 2)),
                 lambda: transforms.load_image(path, (2, 2), decode_device=native_io.resolve())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert native_io.available() is False and native_io.available("cpu") is True
    with pytest.raises(ValueError):
        resize_cuda.decode_resize(b"\xff\xd8", (2, 2), "cpu")


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Loader threads count their launches at once: 16 threads (more than
    the cores) x 2000 counts each, switching every microsecond; one count
    a size group, the kernel's only counter."""
    import sys
    import threading
    monkeypatch.setattr(resize_cuda.resize, "launches", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [resize_cuda._counted(1) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert resize_cuda.resize.launches == 16 * 2000
    assert not hasattr(resize_cuda.resize, "h_launches")


def test_the_ingest_builds_nothing_on_the_cpu(files):
    native_io.load_batch_native([files["jpeg 4:2:0", "noise /4"]], (24, 40), device="cpu")
    assert resize_cuda._lib is None and not build.library_path("io").exists()
    assert resize_cuda.resize.launches == 0


@pytest.fixture
def card_stand_in(monkeypatch):
    """resize_cuda's card entries stood in for on the CPU: nvJPEG refuses
    every JPEG; rgb_resize takes resize_plain and records its backend."""
    counted = []

    def rgb_resize(rgb, size_hw, device, mean=None, std=None, backend="host"):
        counted.append(backend)
        return resize_cuda.resize_plain(torch.from_numpy(rgb), size_hw, mean, std).numpy()

    monkeypatch.setattr(resize_cuda, "decode_resize", lambda *a, **k: (None, resize_cuda.REFUSED))
    monkeypatch.setattr(resize_cuda, "rgb_resize", rgb_resize)
    monkeypatch.setattr(native_io, "_warned_refused", False)
    return counted


@pytest.mark.parametrize("normalized", [False, True])
def test_a_jpeg_nvjpeg_refuses_is_decoded_on_the_host_and_resized_on_the_card(
        files, card_stand_in, normalized):
    """A JPEG that nvJPEG does not decode takes PIL's decode and the card's
    resize, counted as refused, with one warning; the result is the plain
    version's."""
    load = native_io.load_image_native if normalized else native_io.load_image_raw_native
    path, hw = files["jpeg 4:2:0", "noise non-integer"], SIZES["noise non-integer"][2]
    with pytest.warns(UserWarning, match="nvJPEG does not decode"):
        got = load(path, hw, torch.device("cuda", 0))
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = load(path, hw, torch.device("cuda", 0))
    want = load(path, hw, "cpu")
    assert np.array_equal(got, want) and np.array_equal(again, want)
    assert card_stand_in == [resize_cuda.REFUSED] * 2


def test_load_batch_decodes_refused_jpegs_on_the_host(files, card_stand_in, monkeypatch):
    """load_batch_native on the card: a JPEG nvJPEG decoded keeps the card's
    pixels, a refused one and a PNG take PIL's decode and the card's
    resize; a broken JPEG makes the batch None."""
    hw = SIZES["noise /4"][2]
    paths = [files["jpeg 4:2:0", "noise /4"], files["jpeg 4:4:4", "noise /4"],
             files["png rgb", "noise /4"]]
    decoded = np.full((2, *hw, 3), 7.0, np.float32)
    monkeypatch.setattr(resize_cuda, "load_batch", lambda datas, *a: (
        decoded, np.array([True, False]), ["gpu_hybrid", resize_cuda.REFUSED]))
    with pytest.warns(UserWarning, match="nvJPEG does not decode"):
        got = native_io.load_batch_native(paths, hw, device=torch.device("cuda", 0))
    want = native_io.load_batch_native(paths, hw, device="cpu")
    assert np.array_equal(got[0], decoded[0]) and np.array_equal(got[1:], want[1:])
    assert card_stand_in == [resize_cuda.REFUSED, "host"]
    monkeypatch.setattr(resize_cuda, "load_batch", lambda datas, *a: (
        decoded, np.array([True, False]), ["gpu_hybrid", None]))
    assert native_io.load_batch_native(paths, hw, device=torch.device("cuda", 0)) is None


# (input batch [N, H, W], output (h, w), tile (rows, columns), band rows a
# chunk): VIGOR's panorama alone and in a batch on 8 x 64 tiles, two chunks
# a tile; chip_smoke.py's cases (a non-integer downscale, an upscale, a row
# too wide for a 64-column tile's band in 48 KB on 8 x 32 tiles, a row of no
# multiple of 4 bytes); a steep downscale whose band is streamed in 25 row
# chunks; a steep horizontal downscale on 2 x 2 tiles, one band row a chunk
# (the kernel's plan past 48 KB)
TILED = {
    "vigor one": ((1, *VIGOR_IN), VIGOR_OUT, (8, 64), 16),
    "vigor batch": ((3, *VIGOR_IN), VIGOR_OUT, (8, 64), 16),
    "noise non-integer": ((3, 96, 160), (37, 91), (8, 64), 16),
    "noise upscale": ((2, 40, 56), (75, 130), (8, 64), 16),
    "wide row": ((1, 24, 5000), (10, 1250), (8, 32), 16),
    "odd row": ((2, 33, 77), (10, 20), (8, 64), 16),
    "steep downscale": ((2, 400, 96), (5, 24), (8, 64), 16),
    "steep horizontal": ((1, 30, 20000), (4, 10), (2, 2), 1),
}


def noise_u8(shape, seed=20):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (*shape, 3),
                                                                 dtype=np.uint8))


def band_rows(in_size, out_size, tile):
    """The most input rows a tile of `tile` output rows reads."""
    first, taps, _ = resize_cuda.contributions(in_size, out_size)
    last = np.minimum(np.arange(0, out_size, tile) + tile, out_size) - 1
    return int((first[last] + taps[last] - first[::tile]).max())


@pytest.mark.parametrize("normalized", [False, True], ids=["uint8", "normalized"])
@pytest.mark.parametrize("case", list(TILED))
def test_the_kernels_tiles_give_resize_plains_bits(case, normalized):
    """resize_plain_tiled at a tile and a chunk of band rows the kernel
    takes equals resize_plain bit for bit: every tap inside its tile's band,
    halo columns summed alike by both tiles, chunked sums in tap order."""
    shape, hw, tile_hw, chunk = TILED[case]
    x = noise_u8(shape)
    mean, std = (transforms.IMAGENET_MEAN, transforms.IMAGENET_STD) if normalized else (None,
                                                                                         None)
    got = resize_cuda.resize_plain_tiled(x, hw, tile_hw, mean, std, chunk)
    want = resize_cuda.resize_plain(x, hw, mean, std)
    assert got.dtype == want.dtype and got.shape == want.shape == (shape[0], *hw, 3)
    assert torch.equal(got, want)
    chunks = -(-band_rows(shape[1], hw[0], tile_hw[0]) // chunk)
    assert chunks == {"vigor one": 2, "vigor batch": 2, "steep downscale": 25,
                      "steep horizontal": 19}.get(case, chunks)


@pytest.mark.parametrize("tile_hw,chunk", [((3, 5), 2), ((1, 1), 1), ((8, 64), 5), ((16, 7), 3)])
def test_any_tile_and_chunk_give_resize_plains_bits(tile_hw, chunk):
    """Ragged tiles at the image's edges and chunks that split an output
    row's taps: the same bits."""
    x = noise_u8((2, 96, 160), seed=21)
    for mean, std in ((None, None), (transforms.IMAGENET_MEAN, transforms.IMAGENET_STD)):
        got = resize_cuda.resize_plain_tiled(x, (37, 91), tile_hw, mean, std, chunk)
        assert torch.equal(got, resize_cuda.resize_plain(x, (37, 91), mean, std))
    assert torch.equal(resize_cuda.resize_plain_tiled(x[0], (37, 91), tile_hw, chunk_rows=chunk),
                       resize_cuda.resize_plain(x[0], (37, 91)))


def test_resize_bytes_are_the_functions():
    """The input read once and the output written once: no float rows."""
    n, (in_h, in_w), (out_h, out_w) = 8, VIGOR_IN, VIGOR_OUT
    assert resize_cuda.resize_bytes(n, in_h, in_w, out_h, out_w, True) == 8 * (
        1024 * 2048 * 3 + 4 * 320 * 640 * 3) == 69992448
    assert resize_cuda.resize_bytes(1, in_h, in_w, out_h, out_w, False) == 6291456 + 614400
    assert resize_cuda.resize_bytes(2, 33, 77, 10, 20, True) == 2 * (33 * 77 * 3 + 4 * 600)


@pytest.mark.parametrize("in_size,out_size", [(1024, 320), (2048, 640), (56, 130), (5000, 1250),
                                              (400, 5), (20000, 10)])
def test_the_resize_window_never_moves_back(in_size, out_size):
    """From one output to the next, neither the first tap nor the one past
    the last moves back: a tile's band runs from its first output's first
    tap to its last output's last (csrc/io.cu's get_contribs refuses a size
    pair where it would not)."""
    first, taps, _ = resize_cuda.contributions(in_size, out_size)
    assert (np.diff(first) >= 0).all() and (np.diff(first + taps) >= 0).all()
    assert (taps >= 1).all() and first[0] == 0 and first[-1] + taps[-1] == in_size
