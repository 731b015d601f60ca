"""Build the port's CUDA C++ sources with nvcc for Hopper (sm_90a).

Each kernel source `csrc/<name>.cu` exposes a plain C interface and is
compiled into its own shared library under `csrc/_build/`, named by a hash
of the source and the flags, at first use; `ops/*_cuda.py` load it with
ctypes. Nothing is compiled when this module is imported. A failed build
raises with nvcc's output.

    python -m ccvpe_tpu_torch.csrc.build      # build every kernel, print ptxas
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Sequence

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC / "_build"
KERNELS = ("corr", "lmu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills, kept in the log
)


@dataclasses.dataclass(frozen=True)
class Built:
    path: Path       # the shared library
    log: str         # nvcc's output (ptxas resource usage); "" if cached
    seconds: float   # build time; 0.0 if cached


def nvcc() -> str:
    """The nvcc executable: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def nvcc_command(sources: Sequence[Path], output: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(output), *map(str, sources)]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Built:
    """Compile csrc/<name>.cu unless this exact source is built already."""
    out = library_path(name)
    if out.exists():
        return Built(out, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command([CSRC / f"{name}.cu"], tmp)
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return Built(out, log, seconds)


if __name__ == "__main__":
    for kernel in KERNELS:
        b = build(kernel)
        print(f"{kernel}: {b.path} ({b.seconds:.1f} s)\n{b.log}")
