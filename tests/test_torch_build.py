"""csrc/build.py's preprocessor defines: each define set is a library of its
own (the defines are in the hash), and the build without defines keeps the
name it had before defines existed, so the main path's library is the same
file. Nothing is compiled here."""

import hashlib

import pytest

from ccvpe_tpu_torch.csrc import build
from ccvpe_tpu_torch.ops import lmu_cuda


@pytest.mark.parametrize("name", build.KERNELS)
def test_defines_give_their_own_library_and_keep_the_default(name):
    src = (build.CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert build.library_path(name) == build.BUILD_DIR / f"lib{name}-{digest}.so"
    assert build.library_path(name, ()) == build.library_path(name)
    paths = {build.library_path(name), build.library_path(name, ("A",)),
             build.library_path(name, ("B",)), build.library_path(name, ("A", "B"))}
    assert len(paths) == 4
    assert all(p.parent == build.BUILD_DIR for p in paths)


def test_nvcc_command_passes_the_defines():
    src, out = build.CSRC / "lmu.cu", build.BUILD_DIR / "x.so"
    plain = build.nvcc_command([src], out)
    timed = build.nvcc_command([src], out, (lmu_cuda.PHASE_TIMER,))
    assert not any(f.startswith("-D") for f in plain)
    assert f"-D{lmu_cuda.PHASE_TIMER}" in timed
    assert [f for f in timed if not f.startswith("-D")] == plain
