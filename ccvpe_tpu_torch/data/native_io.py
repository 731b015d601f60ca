"""Decode, resize and normalize image files on the card (the port of
ccvpe_tpu/data/native_io.py, which binds native/io.cc on the host).

The same API, with a device: `load_image_native` (normalized float32 [H, W,
3]), `load_image_raw_native` (uint8) and `load_batch_native` (float32 [N, H,
W, 3]) give None where io.cc gives non-zero: a file that is neither JPEG nor
PNG (by its magic bytes), or whose bitstream no decoder takes; the caller
(data/transforms.py::load_image) then degrades to PIL, as the JAX package
does.

`device=None` means the card, and raises without one. On the card a JPEG is
decoded by nvJPEG and resized by csrc/io.cu's resize kernel
(ops/resize_cuda.py); a PNG is decoded by PIL on the host (the card's
machine has no libpng) and resized by the same kernel, and so is a JPEG
that nvJPEG does not decode (libjpeg may: a warning the first time, each
such file counted in resize_cuda.backend_counts()["refused"]). A failed
build or launch, or a CUDA or nvJPEG fault, raises: nothing on the card
gives way to the host. `device="cpu"` is the plain version: PIL's decode, then
ops/resize_cuda.py::resize_plain, the kernel's arithmetic in torch. PIL is
imported where an image is read.

Traced (core/profiling.py): the spans `ingest.read` (the file's bytes),
`ingest.decode` (nvJPEG's decode and resize of a JPEG, or PIL's decode) and
`ingest.resize` (the resize of what PIL decoded, on the card the
kernel's launch, ops/resize_cuda.py).
"""

from __future__ import annotations

import concurrent.futures
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccvpe_tpu_torch.core.profiling import span
from ccvpe_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ccvpe_tpu_torch.ops import resize_cuda

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_warned_refused = False


def resolve(device=None) -> torch.device:
    """None means the card; without one it raises rather than decode on the
    host (models/cvm.py::resolve_device's rule). A card without an index
    takes the calling thread's current one, so a dataset resolved on the
    main thread decodes there from its loader's threads too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to decode on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def available(device=None) -> bool:
    """Whether images decode on `device`: the CPU's plain version always; on
    the card, once csrc/io.cu builds and nvJPEG's handles are created (a
    build or nvJPEG fault raises). False where device is None and there is
    no card."""
    if device is None and not torch.cuda.is_available():
        return False
    device = resolve(device)
    if device.type == "cuda":
        resize_cuda.init(device.index)
    return True


def kind(data: bytes) -> Optional[str]:
    """'jpeg' or 'png' by the magic bytes (io.cc::decode_file), else None."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == PNG_MAGIC:
        return "png"
    return None


def _read(path: str) -> Optional[bytes]:
    try:
        with span("ingest.read"), open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def pil_rgb(data: bytes) -> Optional[np.ndarray]:
    """PIL's decode to uint8 RGB [H, W, 3] (alpha dropped, as io.cc's
    png_set_strip_alpha), or None where PIL cannot decode the bytes."""
    import io

    import PIL.Image
    try:
        with PIL.Image.open(io.BytesIO(data)) as img:
            return np.array(img.convert("RGB"), np.uint8)
    except Exception:  # noqa: BLE001 - any decode failure is io.cc's 1
        return None


def _host_decoded(data: bytes, size_hw, device, mean, std,
                  backend: str = "host") -> Optional[np.ndarray]:
    """PIL's decode, then the resize: on the card, counted under `backend`
    ("host" a PNG, REFUSED a JPEG nvJPEG does not decode); else the plain
    version."""
    global _warned_refused
    if backend == resize_cuda.REFUSED and not _warned_refused:
        _warned_refused = True
        warnings.warn("nvJPEG does not decode a JPEG that PIL may: PIL decodes such files on "
                      "the host and the card resizes them (counted in "
                      "resize_cuda.backend_counts()['refused'])", stacklevel=3)
    with span("ingest.decode"):
        rgb = pil_rgb(data)
    if rgb is None:
        return None
    if device.type == "cuda":       # the kernel's launch is the span ingest.resize
        return resize_cuda.rgb_resize(rgb, size_hw, device, mean, std, backend)
    with span("ingest.resize"):
        return resize_cuda.resize_plain(torch.from_numpy(rgb), size_hw, mean, std).numpy()


def _decode_resize(path: str, size_hw, device, normalized: bool) -> Optional[np.ndarray]:
    device = resolve(device)
    data = _read(path)
    what = kind(data) if data is not None else None
    if what is None:
        return None
    mean, std = (IMAGENET_MEAN, IMAGENET_STD) if normalized else (None, None)
    if device.type == "cuda" and what == "jpeg":
        with span("ingest.decode"):
            got = resize_cuda.decode_resize(data, size_hw, device, mean, std)
        if got is None:
            return None
        img, backend = got
        if img is not None:
            return img
        return _host_decoded(data, size_hw, device, mean, std, backend)
    return _host_decoded(data, size_hw, device, mean, std)


def load_image_native(path: str, size_hw: Tuple[int, int], device=None) -> Optional[np.ndarray]:
    """Decode + resize + ImageNet-normalize one image to [H, W, 3] float32,
    or None where io.cc would fail (the caller falls back to PIL)."""
    return _decode_resize(path, size_hw, device, normalized=True)


def load_image_raw_native(path: str, size_hw: Tuple[int, int],
                          device=None) -> Optional[np.ndarray]:
    """Decode + resize one image to uint8 [H, W, 3] (no normalization), or
    None where io.cc would fail."""
    return _decode_resize(path, size_hw, device, normalized=False)


def load_batch_native(paths: Sequence[str], size_hw: Tuple[int, int], num_threads: int = 8,
                      device=None) -> Optional[np.ndarray]:
    """Decode a batch into [N, H, W, 3] float32 with `num_threads` threads,
    or None where any file fails (io.cc::ccvpe_load_batch's count of
    failures). On the card the JPEGs decode at once, each size group
    resized in one launch a pass; PNGs, and JPEGs nvJPEG does not decode,
    one by one after PIL's decode."""
    device = resolve(device)
    if device.type != "cuda":
        with concurrent.futures.ThreadPoolExecutor(max(1, num_threads)) as pool:
            outs = list(pool.map(lambda p: load_image_native(p, size_hw, device), paths))
        if any(o is None for o in outs):
            return None
        return np.stack(outs) if outs else np.empty((0, *size_hw, 3), np.float32)
    datas: List[Optional[bytes]] = [_read(p) for p in paths]
    kinds = [kind(d) if d is not None else None for d in datas]
    if any(k is None for k in kinds):
        return None
    out = np.empty((len(paths), *size_hw, 3), np.float32)
    on_host = {i: "host" for i, k in enumerate(kinds) if k == "png"}
    jpegs = [i for i, k in enumerate(kinds) if k == "jpeg"]
    if jpegs:
        with span("ingest.decode"):
            got, ok, backends = resize_cuda.load_batch([datas[i] for i in jpegs], size_hw,
                                                       device, IMAGENET_MEAN, IMAGENET_STD,
                                                       num_threads)
        for j, i in enumerate(jpegs):
            if backends[j] == resize_cuda.REFUSED:
                on_host[i] = resize_cuda.REFUSED
            elif not ok[j]:
                return None
            else:
                out[i] = got[j]
    for i, backend in sorted(on_host.items()):
        img = _host_decoded(datas[i], size_hw, device, IMAGENET_MEAN, IMAGENET_STD, backend)
        if img is None:
            return None
        out[i] = img
    return out
