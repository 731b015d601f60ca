"""The port stands alone: no import of jax, flax, optax or ccvpe_tpu, in
the source (ast, chip_smoke.py included) or at run time (a fresh
interpreter); the CUDA build targets sm_90a into a directory git ignores,
and nothing is compiled here."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ccvpe_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ccvpe_tpu"}
PORT_FILES = sorted(PORT.rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_forbidden_import_in_source(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py, the port's smoke run on the card, stands alone too."""
    assert not set(_imported_roots(ROOT / "chip_smoke.py")) & FORBIDDEN


def test_no_forbidden_module_at_run_time():
    """Every module of the package, found by walking it and checked against
    the files on disk, imports without JAX, without building a kernel, and
    without PIL (the data layer imports it where it reads an image)."""
    on_disk = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                     for p in PORT_FILES if p != PORT / "__init__.py")
    code = (
        "import importlib, pkgutil, sys\n"
        "import ccvpe_tpu_torch\n"
        "names = sorted(m.name for m in pkgutil.walk_packages(ccvpe_tpu_torch.__path__, 'ccvpe_tpu_torch.'))\n"
        f"assert names == {on_disk!r}, names\n"
        "for name in names: importlib.import_module(name)\n"
        "from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda\n"
        "for mod in (corr_cuda, lmu_cuda):\n"
        "    assert mod.load_library.cache_info().currsize == 0, 'built at import'\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN | {'PIL'})!r})\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_nvcc_command_targets_sm_90a():
    from ccvpe_tpu_torch.csrc import build
    cmd = build.nvcc_command([build.CSRC / "corr.cu"], build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert build.library_path("corr").parent == build.BUILD_DIR
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()


def test_build_dir_is_ignored_by_git():
    from ccvpe_tpu_torch.csrc import build
    rel = build.BUILD_DIR.relative_to(ROOT).as_posix() + "/"
    lines = (ROOT / ".gitignore").read_text().split()
    assert rel in lines


def test_importing_the_package_registers_the_ops():
    """A program from serve.py::export_program loads after `import
    ccvpe_tpu_torch` alone: the import registers B1's and B2's forward ops,
    and builds nothing."""
    code = ("import torch, ccvpe_tpu_torch\n"
            "from ccvpe_tpu_torch.ops import corr_cuda, lmu_cuda\n"
            "print(torch.ops.ccvpe_tpu_torch.corr_fwd.default._schema)\n"
            "print(torch.ops.ccvpe_tpu_torch.lmu_fwd.default._schema)\n"
            "assert corr_cuda.load_library.cache_info().currsize == 0\n"
            "assert lmu_cuda.load_library.cache_info().currsize == 0\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "corr_fwd(Tensor s_flat" in proc.stdout and "lmu_fwd(Tensor x" in proc.stdout
