"""Build the port's CUDA C++ sources with nvcc for Hopper (sm_90a).

Each kernel source `csrc/<name>.cu` exposes a plain C interface and is
compiled into its own shared library under `csrc/_build/`, named by a hash
of the source, of every header `csrc/*.cuh` (the sources include them) and
of the flags, at first use; `ops/*_cuda.py` load it with ctypes. A build
may add preprocessor defines (`build("lmu", ("X",))` compiles with -DX):
they are part of the hash, so each define set is a library of its own.
Nothing is compiled when this module is imported. A failed build raises
with nvcc's output.

    python -m ccvpe_tpu_torch.csrc.build      # build every library, print ptxas
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
# every library the port loads: each kernel, and lmu.cu's bf16 instantiations
# (ops/lmu_cuda.py::BF16_BUILD)
LIBRARIES = (("corr", ()), ("lmu", ()), ("lmu", ("CCVPE_LMU_BF16",)))
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


def _define_flags(defines: Sequence[str]) -> List[str]:
    return [f"-D{d}" for d in defines]


def nvcc_command(sources: Sequence[Path], output: Path, defines: Sequence[str] = ()) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, *_define_flags(defines), "-o", str(output), *map(str, sources)]


def headers() -> List[Path]:
    """The headers the sources may include, in name order."""
    return sorted(CSRC.glob("*.cuh"))


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The library of csrc/<name>.cu: named by a hash of the source, then
    each header's name and bytes, then the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for h in headers():
        digest.update(h.name.encode() + h.read_bytes())
    digest.update(" ".join([*NVCC_FLAGS, *_define_flags(defines)]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines: Sequence[str] = ()) -> Built:
    """Compile csrc/<name>.cu with -D for each of `defines`, unless this
    exact source is built already with them."""
    out = library_path(name, defines)
    if out.exists():
        return Built(out, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command([CSRC / f"{name}.cu"], tmp, defines)
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
    for kernel, defines in LIBRARIES:
        b = build(kernel, defines)
        print(f"{kernel} {' '.join(defines)}: {b.path} ({b.seconds:.1f} s)\n{b.log}")
