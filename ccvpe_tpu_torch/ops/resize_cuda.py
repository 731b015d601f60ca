"""Pillow's triangle resize and the ImageNet normalize on Hopper: the wrapper
of csrc/io.cu's resize kernel and of its nvJPEG decode glue, the port of
native/io.cc (build_contribs :147, resize_normalize :179, resize_u8 :231;
the JAX package binds it in ccvpe_tpu/data/native_io.py). No TPU kernel:
the JAX package resizes on the host in C++, so the kernel was added to keep
the panoramas' ingest on the card beside nvJPEG's decode.

`contributions(in_size, out_size)` are Pillow's triangle weights in float64,
computed as io.cc computes them and cast to float32 as io.cc casts them.
The resize sums the vertical taps from uint8 rows into float rows, then
gathers the horizontal taps and ends in the normalize ((v - 255 mean) *
(1/255 / std)) or in the round int(v + 0.5) and clip to uint8, as io.cc
does. Each sum runs over the taps in order from the first, one rounded
product and one rounded add a tap (no fused multiply-add), so
`resize_plain`, the two sums as two passes in torch, gives the kernel's
bits on identical input. The kernel does both sums in one launch, a block
a tile of the output with its band of input in shared memory (the tile
and its chunks of band rows as csrc/io.cu plans them: `resize_plan`);
`resize_plain_tiled` is its arithmetic tile by tile, for the tests.

`resize` launches the kernel on a CUDA uint8 batch [N, H, W, 3] (one launch
for the batch) and takes `resize_plain` for a CPU one. `decode_resize`,
`rgb_resize` and `load_batch` are the ingest path's entries: bytes of a
JPEG, or host RGB pixels, in; the resized image in a numpy array out,
decoded and resized on the card. nvJPEG upsamples chroma with
interpolation, as libjpeg does; a handle it will not make so raises. Each
call leases a decoder state of its own (a non-blocking stream, nvJPEG's
states, pinned and device buffers) from a pool kept for the process, so
loader threads decode at once, and runs in CUDA's relaxed stream-capture
mode, so a CUDA graph that another thread captures meanwhile stays valid.
Every launch of the kernel, on any route, adds one to `resize.launches`
(core/profiling.py::counters()' `launches.resize`; no CUDA graph captures
the resize, so core/graphs.py's replay bookkeeping leaves it out). A
failed build, launch, CUDA or nvJPEG call raises (`IngestError`), and so
does a size whose one output's band of input does not fit in shared
memory; a broken JPEG gives None, as io.cc gives 1 for a file it cannot
decode; a JPEG that nvJPEG does not decode (JPEG_NOT_SUPPORTED, or no
backend takes it) is marked REFUSED, for the caller to decode on the host
and resize here (`rgb_resize(..., backend="refused")`).
Nothing here touches nvcc or the card until a call asks for the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ccvpe_tpu_torch.core.profiling import register_launches, span

# csrc/io.cu's statuses: 0 done, 1 a broken JPEG, 4 a JPEG nvJPEG does not
# decode (2 a CUDA or nvJPEG fault, 3 bad arguments: both raise)
OK, UNDECODABLE, UNSUPPORTED = 0, 1, 4
# csrc/io.cu's per-file backends, in the order of ccvpe_io_backend_counts:
# nvJPEG's three; PNGs decoded on the host; JPEGs nvJPEG refused, decoded
# on the host
BACKENDS = ("hardware", "gpu_hybrid", "hybrid", "host", "refused")
REFUSED = "refused"
# output modes: resized uint8, or normalized float32
U8, NORMALIZED = 0, 1


class IngestError(RuntimeError):
    """A CUDA or nvJPEG fault, or a call the library refused."""


@functools.lru_cache(maxsize=64)
def contributions(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's triangle (bilinear with antialias) weights for one axis, as
    native/io.cc::build_contribs computes them: (first [out] int64, taps
    [out] int64, weights [out, ksize] float64, zero past each row's taps).
    The support grows with the downscale factor; each row sums to 1."""
    if in_size < 1 or out_size < 1:
        raise ValueError(f"sizes must be positive, got {in_size} -> {out_size}")
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        total = 0.0
        for x in range(hi - lo):
            arg = (x + lo - center + 0.5) / filterscale
            w = max(1.0 + arg if arg < 0 else 1.0 - arg, 0.0)
            weights[xx, x] = w
            total += w
        if total != 0.0:
            weights[xx, :hi - lo] /= total
        first[xx], taps[xx] = lo, hi - lo
    for a in (first, taps, weights):
        a.setflags(write=False)     # cached: every caller shares them
    return first, taps, weights


def normalize_constants(mean, std) -> Tuple[np.ndarray, np.ndarray]:
    """(255 * mean, (1/255) / std) in float32, as io.cc forms them."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return mean * np.float32(255.0), (np.float32(1.0) / np.float32(255.0)) / std


def _taps(in_size: int, out_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each output row's input indices (clamped past its taps, where the
    weight is 0) and float32 weights, [out, ksize]."""
    first, _, weights = contributions(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), in_size - 1)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(weights.astype(np.float32)).to(device))


def _check_u8(x: torch.Tensor) -> None:
    if x.dtype != torch.uint8 or x.dim() not in (3, 4) or x.shape[-1] != 3:
        raise ValueError(f"resize takes uint8 [N, H, W, 3] or [H, W, 3], got "
                         f"{x.dtype} {tuple(x.shape)}")


def resize_plain_v(x: torch.Tensor, out_h: int) -> torch.Tensor:
    """The vertical pass: uint8 [N, H, W, 3] -> float rows [N, out_h, W, 3],
    each sum tap by tap from the first (a zero weight past a row's taps
    adds nothing)."""
    n, in_h, in_w, _ = x.shape
    rows = x.reshape(n, in_h, in_w * 3).float()
    idx, w = _taps(in_h, out_h, x.device)
    tmp = w[:, 0, None] * rows[:, idx[:, 0]]
    for k in range(1, w.shape[1]):
        tmp = tmp + w[:, k, None] * rows[:, idx[:, k]]
    return tmp.reshape(n, out_h, in_w, 3)


def resize_plain_h(tmp: torch.Tensor, out_w: int, mean=None, std=None) -> torch.Tensor:
    """The horizontal pass: float rows [N, H, W, 3] -> [N, H, out_w, 3],
    rounded to uint8 (mean and std None) or normalized float32."""
    n, h, in_w, _ = tmp.shape
    dev = tmp.device
    idx, w = _taps(in_w, out_w, dev)
    acc = torch.zeros((n, h, out_w, 3), dtype=torch.float32, device=dev)
    for k in range(w.shape[1]):
        acc = acc + w[None, None, :, k, None] * tmp[:, :, idx[:, k]]
    if mean is None:
        return torch.trunc(acc + 0.5).clamp(0, 255).to(torch.uint8)
    bias, inv = (torch.from_numpy(c).to(dev) for c in normalize_constants(mean, std))
    return (acc - bias) * inv


def resize_plain(u8_hwc: torch.Tensor, size_hw: Tuple[int, int], mean=None,
                 std=None) -> torch.Tensor:
    """The kernel's arithmetic in torch: uint8 [H, W, 3] or [N, H, W, 3] ->
    [.., out_h, out_w, 3] uint8 (mean and std None) or float32 normalized
    by them; the vertical sums, then the horizontal ones, each as a pass
    over the whole image."""
    _check_u8(u8_hwc)
    if (mean is None) != (std is None):
        raise ValueError("pass both mean and std, or neither")
    x = u8_hwc if u8_hwc.dim() == 4 else u8_hwc[None]
    out = resize_plain_h(resize_plain_v(x, size_hw[0]), size_hw[1], mean, std)
    return out if u8_hwc.dim() == 4 else out[0]


def resize_plain_tiled(u8_hwc: torch.Tensor, size_hw: Tuple[int, int],
                       tile_hw: Tuple[int, int], mean=None, std=None,
                       chunk_rows: int = 16) -> torch.Tensor:
    """csrc/io.cu's resize_kernel in torch, block by block: for each tile of
    tile_hw outputs, the band of input its taps read, the vertical sums
    into a float tile of the band's columns, `chunk_rows` band rows at a
    time (each sum continued from chunk to chunk in tap order), then the
    horizontal taps gathered from that tile, all indices relative to the
    band. Same contract as resize_plain, whose bits it gives; for the
    tests."""
    _check_u8(u8_hwc)
    if (mean is None) != (std is None):
        raise ValueError("pass both mean and std, or neither")
    x = u8_hwc if u8_hwc.dim() == 4 else u8_hwc[None]
    n, in_h, in_w, _ = x.shape
    (out_h, out_w), (tr, tc) = size_hw, tile_hw
    fy, ny, wy = contributions(in_h, out_h)
    fx, nx, wx = contributions(in_w, out_w)
    wy, wx = (torch.from_numpy(w.astype(np.float32)) for w in (wy, wx))
    rows = x.reshape(n, in_h, in_w * 3)
    out = torch.empty((n, out_h, out_w, 3), dtype=torch.uint8 if mean is None else torch.float32)
    if mean is not None:
        bias, inv = (torch.from_numpy(c) for c in normalize_constants(mean, std))
    for y0 in range(0, out_h, tr):
        ys = range(y0, min(y0 + tr, out_h))
        by0, by1 = int(fy[ys[0]]), int(fy[ys[-1]] + ny[ys[-1]])
        for x0 in range(0, out_w, tc):
            xs = np.arange(x0, min(x0 + tc, out_w))
            bx0, bx1 = int(fx[xs[0]]), int(fx[xs[-1]] + nx[xs[-1]])
            band = rows[:, by0:by1, 3 * bx0:3 * bx1]
            tile = torch.zeros((n, len(ys), band.shape[2]), dtype=torch.float32)
            for c0 in range(0, by1 - by0, chunk_rows):
                chunk = band[:, c0:c0 + chunk_rows].float()
                for i, y in enumerate(ys):
                    f = int(fy[y]) - by0
                    for k in range(max(0, c0 - f), min(int(ny[y]), c0 + chunk.shape[1] - f)):
                        tile[:, i] = tile[:, i] + wy[y, k] * chunk[:, f + k - c0]
            # the horizontal taps, zero weights past a column's (adding 0)
            px = tile.reshape(n, len(ys), bx1 - bx0, 3)
            acc = torch.zeros((n, len(ys), len(xs), 3), dtype=torch.float32)
            for k in range(wx.shape[1]):
                at = torch.from_numpy(np.minimum(fx[xs] - bx0 + k, bx1 - bx0 - 1))
                acc = acc + wx[xs, k][None, None, :, None] * px[:, :, at]
            if mean is None:
                acc = torch.trunc(acc + 0.5).clamp(0, 255).to(torch.uint8)
            else:
                acc = (acc - bias) * inv
            out[:, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = acc
    return out if u8_hwc.dim() == 4 else out[0]


def resize_bytes(n: int, in_h: int, in_w: int, out_h: int, out_w: int, normalized: bool) -> int:
    """Bytes the resize must move for n images: the uint8 input read once,
    the output (uint8, or float32 normalized) written once."""
    return n * in_h * in_w * 3 + (4 if normalized else 1) * n * out_h * out_w * 3


_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def toolkit_roots() -> list:
    """The CUDA toolkit's directories: nvcc's, and CUDA_HOME's (default
    /usr/local/cuda)."""
    from ccvpe_tpu_torch.csrc.build import nvcc
    roots = {Path(nvcc()).resolve().parents[1],
             Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")).resolve()}
    return sorted(r for r in roots if r.is_dir())


def nvjpeg_paths() -> list:
    """The toolkit's nvJPEG shared libraries (under lib64 or targets/*/lib),
    in name order."""
    return sorted({p.resolve() for root in toolkit_roots()
                   for d in [root / "lib64", *root.glob("targets/*/lib")]
                   for p in d.glob("libnvjpeg.so*")})


def bind(path) -> ctypes.CDLL:
    """Load a build of csrc/io.cu and set its C entries' types."""
    lib = ctypes.CDLL(str(path))
    p, i, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(i)
    for name, args in (
            ("ccvpe_io_init", [i, ip]),
            ("ccvpe_io_last_error", [ctypes.c_char_p, i]),
            ("ccvpe_io_image_info", [p, z, i, ip, ip]),
            ("ccvpe_io_decode", [p, z, p, z, i, ip]),
            ("ccvpe_io_decode_resize", [p, z, p, i, i, i, p, p, i, ip]),
            ("ccvpe_io_rgb_resize", [p, i, i, p, i, i, i, p, p, i, i]),
            ("ccvpe_io_load_batch", [p, p, i, p, i, i, i, p, p, i, i, ip, ip, ip]),
            ("ccvpe_io_resize", [p, i, i, i, p, i, i, i, p, p, i, p]),
            ("ccvpe_io_resize_plan", [i, i, i, i, i, ip])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    lib.ccvpe_io_backend_counts.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.ccvpe_io_backend_counts.restype = None
    return lib


def load_library() -> ctypes.CDLL:
    """Build csrc/io.cu (linked with nvJPEG) for sm_90a at first use and
    bind its C entries; threads that ask at once wait for one build. The
    toolkit's libnvjpeg is loaded first, where the loader's path lacks it."""
    global _lib
    with _lock:
        if _lib is None:
            from ccvpe_tpu_torch.csrc.build import build
            built = build("io")
            for path in nvjpeg_paths()[:1]:
                ctypes.CDLL(str(path), mode=ctypes.RTLD_GLOBAL)
            _lib = bind(built.path)
        return _lib


def _device_index(device) -> int:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the ingest kernels run on a CUDA device, got {device}")
    return device.index if device.index is not None else torch.cuda.current_device()


def _raise(lib, what: str, rc: int):
    msg = ctypes.create_string_buffer(512)
    lib.ccvpe_io_last_error(msg, len(msg))
    raise IngestError(f"{what} failed (status {rc}): {msg.value.decode(errors='replace')}")


@functools.lru_cache(maxsize=8)
def init(index: int) -> Tuple[str, ...]:
    """Create the process's nvJPEG handles on card `index`; the backends
    created (hardware where the card's JPEG engines are offered)."""
    lib = load_library()
    mask = ctypes.c_int(0)
    rc = lib.ccvpe_io_init(index, ctypes.byref(mask))
    if rc != OK:
        _raise(lib, "ccvpe_io_init", rc)
    return tuple(name for bit, name in enumerate(BACKENDS[:3]) if mask.value >> bit & 1)


def backend_counts() -> dict:
    """Files decoded by each backend since the library was loaded (host:
    PNGs decoded by PIL, resized on the card; refused: JPEGs nvJPEG does not
    decode, decoded by PIL, resized on the card)."""
    counts = (ctypes.c_longlong * len(BACKENDS))()
    load_library().ccvpe_io_backend_counts(counts)
    return dict(zip(BACKENDS, counts))


def _consts(mean, std):
    """mean and std as float32 arrays for the C calls (io.cu forms
    normalize_constants from them itself)."""
    if mean is None:
        return None, None
    return (np.ascontiguousarray(mean, np.float32), np.ascontiguousarray(std, np.float32))


def _out(shape_hw, mean, n: Optional[int] = None) -> np.ndarray:
    h, w = shape_hw
    shape = (h, w, 3) if n is None else (n, h, w, 3)
    return np.empty(shape, np.uint8 if mean is None else np.float32)


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data


def _counted(groups: int) -> None:
    """One launch for every size group (loader threads count at once)."""
    with _count_lock:
        resize.launches += groups


def image_size(data: bytes, device) -> Optional[Tuple[int, int]]:
    """(h, w) of a JPEG from its header, or None where nvJPEG cannot read it."""
    index = _device_index(device)
    init(index)
    lib = load_library()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.ccvpe_io_image_info(data, len(data), index, ctypes.byref(h), ctypes.byref(w))
    if rc not in (OK, UNDECODABLE, UNSUPPORTED):
        _raise(lib, "ccvpe_io_image_info", rc)
    return (h.value, w.value) if rc == OK else None


def decode(data: bytes, device) -> Optional[Tuple[np.ndarray, str]]:
    """A JPEG decoded on the card to uint8 RGB [H, W, 3] on the host, and
    the backend that decoded it; None where nvJPEG does not decode it."""
    size = image_size(data, device)
    if size is None:
        return None
    out = np.empty((*size, 3), np.uint8)
    backend = ctypes.c_int(-1)
    lib = load_library()
    rc = lib.ccvpe_io_decode(data, len(data), out.ctypes.data, out.nbytes,
                             _device_index(device), ctypes.byref(backend))
    if rc in (UNDECODABLE, UNSUPPORTED):
        return None
    if rc != OK:
        _raise(lib, "ccvpe_io_decode", rc)
    return out, BACKENDS[backend.value]


def decode_resize(data: bytes, size_hw, device, mean=None,
                  std=None) -> Optional[Tuple[Optional[np.ndarray], str]]:
    """A JPEG decoded and resized on the card: uint8 [H, W, 3] (mean and std
    None) or normalized float32, and the backend that decoded it; None for
    a broken JPEG; (None, REFUSED) for one nvJPEG does not decode."""
    index = _device_index(device)
    init(index)
    lib = load_library()
    out = _out(size_hw, mean)
    m, s = _consts(mean, std)
    backend = ctypes.c_int(-1)
    rc = lib.ccvpe_io_decode_resize(data, len(data), out.ctypes.data, size_hw[0], size_hw[1],
                                    U8 if mean is None else NORMALIZED, _ptr(m), _ptr(s), index,
                                    ctypes.byref(backend))
    if rc == UNDECODABLE:
        return None
    if rc == UNSUPPORTED:
        return None, REFUSED
    if rc != OK:
        _raise(lib, "ccvpe_io_decode_resize", rc)
    _counted(1)
    return out, BACKENDS[backend.value]


def rgb_resize(rgb: np.ndarray, size_hw, device, mean=None, std=None,
               backend: str = "host") -> np.ndarray:
    """Host uint8 RGB [H, W, 3] resized on the card, counted under
    `backend`: "host" for a PNG that PIL decoded, REFUSED for a JPEG that
    nvJPEG does not decode and PIL did."""
    if backend not in ("host", REFUSED):
        raise ValueError(f"rgb_resize counts files under 'host' or {REFUSED!r}, got {backend!r}")
    index = _device_index(device)
    init(index)
    lib = load_library()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb_resize takes uint8 [H, W, 3], got {rgb.shape}")
    out = _out(size_hw, mean)
    m, s = _consts(mean, std)
    rc = lib.ccvpe_io_rgb_resize(rgb.ctypes.data, rgb.shape[0], rgb.shape[1], out.ctypes.data,
                                 size_hw[0], size_hw[1], U8 if mean is None else NORMALIZED,
                                 _ptr(m), _ptr(s), index, BACKENDS.index(backend))
    if rc != OK:
        _raise(lib, "ccvpe_io_rgb_resize", rc)
    _counted(1)
    return out


def load_batch(datas: Sequence[bytes], size_hw, device, mean=None, std=None,
               num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray, list]:
    """JPEGs decoded by `num_threads` threads at once on the card, each size
    group resized in one launch: (out [N, H, W, 3], decoded [N] bool,
    each file's backend: REFUSED for a JPEG nvJPEG does not decode, None
    for a broken one)."""
    index = _device_index(device)
    init(index)
    lib = load_library()
    n = len(datas)
    out = _out(size_hw, mean, n)
    m, s = _consts(mean, std)
    ptrs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_size_t * n)(*map(len, datas))
    status = (ctypes.c_int * n)()
    backend = (ctypes.c_int * n)()
    groups = ctypes.c_int(0)
    rc = lib.ccvpe_io_load_batch(ptrs, lens, n, out.ctypes.data, size_hw[0], size_hw[1],
                                 U8 if mean is None else NORMALIZED, _ptr(m), _ptr(s),
                                 max(1, num_threads), index, status, backend,
                                 ctypes.byref(groups))
    if rc != OK:
        _raise(lib, "ccvpe_io_load_batch", rc)
    _counted(groups.value)
    ok = np.array([st == OK for st in status], bool)
    return out, ok, [BACKENDS[b] if st == OK else REFUSED if st == UNSUPPORTED else None
                     for st, b in zip(status, backend)]


def resize(u8: torch.Tensor, size_hw: Tuple[int, int], mean=None, std=None) -> torch.Tensor:
    """The kernel on a CUDA uint8 batch [N, H, W, 3] (or one [H, W, 3]), on
    the current stream, one launch; `resize_plain` for a CPU tensor. Same
    contract as resize_plain."""
    if u8.device.type != "cuda":
        return resize_plain(u8, size_hw, mean, std)
    _check_u8(u8)
    if not u8.is_contiguous():
        raise ValueError("resize takes a contiguous tensor")
    if (mean is None) != (std is None):
        raise ValueError("pass both mean and std, or neither")
    x = u8 if u8.dim() == 4 else u8[None]
    n, in_h, in_w, _ = x.shape
    out_h, out_w = size_hw
    dev = x.device
    index = _device_index(dev)
    lib = load_library()
    out = torch.empty((n, out_h, out_w, 3), device=dev,
                      dtype=torch.uint8 if mean is None else torch.float32)
    m, s = _consts(mean, std)
    with span("ingest.resize"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccvpe_io_resize(x.data_ptr(), n, in_h, in_w, out.data_ptr(), out_h, out_w,
                                 U8 if mean is None else NORMALIZED, _ptr(m), _ptr(s), index,
                                 stream)
    if rc != OK:
        _raise(lib, "ccvpe_io_resize", rc)
    _counted(1)
    return out if u8.dim() == 4 else out[0]


resize.launches = 0      # the kernel's launches, every route
register_launches("resize", resize)


def resize_plan(in_hw: Tuple[int, int], out_hw: Tuple[int, int], device) -> dict:
    """The plan csrc/io.cu takes for in_hw -> out_hw on `device`: a block's
    output rows `tr` and columns `tc`, band rows a copy group `chunk`, a
    staged row's bytes `pitch`, the block's dynamic shared memory `smem`
    in bytes. Raises where one output's band does not fit in shared memory."""
    index = _device_index(device)
    lib = load_library()
    plan = (ctypes.c_int * 5)()
    rc = lib.ccvpe_io_resize_plan(*in_hw, *out_hw, index, plan)
    if rc != OK:
        _raise(lib, "ccvpe_io_resize_plan", rc)
    return dict(zip(("tr", "tc", "chunk", "pitch", "smem"), plan))
