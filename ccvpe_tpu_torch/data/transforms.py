"""Host-side image transforms: decode, resize, ImageNet-normalize -> NHWC
numpy (the port of ccvpe_tpu/data/transforms.py).

Matches the reference preprocessing (train_VIGOR.py:57-70): torchvision
Resize (PIL bilinear) + ToTensor + Normalize(ImageNet mean/std). GT maps are
not rendered here: the steps render them on the device from scalars
(ops/gt.py). PIL is imported inside the functions, so the module imports
where PIL is missing. `load_image(decode_device=...)` decodes and resizes
through data/native_io.py on that device instead (on the card: nvJPEG and
csrc/io.cu's resize kernel), as the JAX package's load_image takes native/io.cc.
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

logger = logging.getLogger("ccvpe_tpu_torch.data")


def open_rgb(path: str, fallback_wh: Tuple[int, int]):
    """PIL open -> RGB; an unreadable file gives a blank image of
    `fallback_wh` with a logged warning (reference datasets.py:100-105), so
    one corrupt JPEG does not abort a run over a whole split."""
    import PIL.Image
    try:
        return PIL.Image.open(path).convert("RGB")
    except Exception as e:  # noqa: BLE001 - any decode failure degrades
        logger.warning("unreadable image %s (%s); substituting blank", path, e)
        return PIL.Image.new("RGB", fallback_wh)


def resize_pil(img, size_hw: Tuple[int, int]):
    """PIL bilinear resize to (H, W): torchvision Resize on a PIL image
    (train_VIGOR.py:58,66)."""
    import PIL.Image
    h, w = size_hw
    if img.size != (w, h):
        img = img.resize((w, h), PIL.Image.BILINEAR)
    return img


def normalize(img) -> np.ndarray:
    """PIL/uint8 HWC -> float32 HWC, ImageNet-normalized."""
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def finalize(img, dtype: str = "float32") -> np.ndarray:
    """Resized PIL image -> uint8 pixels (normalized on the device by
    train/step.py::device_normalize) or host-normalized float32."""
    if dtype == "uint8":
        return np.asarray(img, np.uint8)
    return normalize(img)


def load_image(path: str, size_hw: Tuple[int, int], fallback_hw=None,
               dtype: str = "float32", decode_device=None) -> np.ndarray:
    """Open -> RGB -> resize -> uint8 or normalized float32. An unreadable
    file gives a blank image of `fallback_hw` (default `size_hw`).

    decode_device None reads with PIL. A device (the card, or "cpu" for the
    plain version) takes data/native_io.py there, unless CCVPE_NATIVE_IO=0
    (the JAX package's switch); where it returns None (a file io.cc refuses
    too), PIL's path gives its blank image and warning."""
    if decode_device is not None and os.environ.get("CCVPE_NATIVE_IO", "1") != "0":
        from ccvpe_tpu_torch.data import native_io
        load = (native_io.load_image_raw_native if dtype == "uint8"
                else native_io.load_image_native)
        out = load(path, size_hw, decode_device)
        if out is not None:
            return out
    h, w = fallback_hw or size_hw
    return finalize(resize_pil(open_rgb(path, (w, h)), size_hw), dtype)
