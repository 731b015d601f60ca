"""csrc/build.py's library names: a hash of the source, of every header
csrc/*.cuh (the sources include them) and of the flags, the preprocessor
defines and the library's link flags among them, so that each define set is
a library of its own and a changed header builds anew. Nothing is compiled
here."""

import hashlib

import pytest

from ccvpe_tpu_torch.csrc import build
from ccvpe_tpu_torch.ops import lmu_cuda


@pytest.mark.parametrize("name", build.KERNELS)
def test_defines_give_their_own_library_and_keep_the_default(name):
    digest = hashlib.sha256((build.CSRC / f"{name}.cu").read_bytes())
    for h in sorted(build.CSRC.glob("*.cuh")):
        digest.update(h.name.encode() + h.read_bytes())
    digest.update(" ".join([*build.NVCC_FLAGS, *build.LINK_FLAGS.get(name, ())]).encode())
    assert build.library_path(name) == build.BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
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


def test_io_links_nvjpeg_and_the_others_nothing():
    """csrc/io.cu links the toolkit's nvJPEG; no other library links
    anything."""
    assert build.LINK_FLAGS == {"io": ("-lnvjpeg",)}
    for name in build.KERNELS:
        cmd = build.nvcc_command([build.CSRC / f"{name}.cu"], build.BUILD_DIR / "x.so",
                                 (), build.LINK_FLAGS.get(name, ()))
        assert [f for f in cmd if f.startswith("-l")] == (["-lnvjpeg"] if name == "io" else [])
    assert build.nvcc_command([build.CSRC / "io.cu"], build.BUILD_DIR / "x.so")[-1].endswith("io.cu")


def test_link_flags_are_part_of_the_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text("// k\n")
    plain = build.library_path("k")
    monkeypatch.setattr(build, "LINK_FLAGS", {"k": ("-lnvjpeg",)})
    linked = build.library_path("k")
    monkeypatch.setattr(build, "LINK_FLAGS", {"k": ("-lnvjpeg", "-lm")})
    assert len({plain, linked, build.library_path("k")}) == 3


def test_headers_are_part_of_the_hash(tmp_path, monkeypatch):
    """A changed, added or renamed header changes every library's name; the
    source alone keeps it."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert first == build.library_path("k") and first.parent == tmp_path / "_build"
    (tmp_path / "a.cuh").write_text("// two\n")
    second = build.library_path("k")
    (tmp_path / "b.cuh").write_text("")
    third = build.library_path("k")
    (tmp_path / "b.cuh").rename(tmp_path / "c.cuh")
    fourth = build.library_path("k")
    (tmp_path / "notes.txt").write_text("not a header")
    assert len({first, second, third, fourth}) == 4
    assert build.library_path("k") == fourth
    assert build.headers() == [tmp_path / "a.cuh", tmp_path / "c.cuh"]


def test_the_kernels_share_one_header():
    """Every kernel source includes the shared header: the model's kernels
    (B1, B2, B3) for its cp.async copies and tensor-core products, the
    ingest's io.cu for its cp.async copies."""
    for name in build.KERNELS:
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "tf32_mma.cuh"' in text
    assert build.headers() == [build.CSRC / "tf32_mma.cuh"]
