"""No module of the benchmark imports JAX, Flax, optax or the JAX package,
and the plain reference imports nothing of the program: by top-level
module name taken whole (the program's name begins with the JAX
package's), in the sources and in a fresh interpreter after a run."""

import ast
import os
import subprocess
import sys

import pytest

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ccvpe_tpu"}
FILES = sorted(p for p in spec.BENCH.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((spec.BENCH / "reference").glob("*.py"))


def roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def rel(p):
    return str(p.relative_to(spec.ROOT))


@pytest.mark.parametrize("path", FILES, ids=rel)
def test_no_jax_in_source(path):
    assert not set(roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=rel)
def test_reference_imports_nothing_of_the_program(path):
    assert set(roots(path)) <= {"__future__", "contextlib", "hashlib", "math", "typing",
                                "torch", "reference"}


def test_the_names_are_taken_whole():
    assert "ccvpe_tpu_torch".split(".")[0] not in FORBIDDEN


def fresh(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code, str(spec.BENCH), str(spec.ROOT)],
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_jax_after_a_run():
    proc = fresh(
        "import sys; sys.path[:0] = sys.argv[1:3]\n"
        "sys.path.insert(0, sys.argv[1] + '/tests')\n"
        "from _cells import tiny_cell\n"
        "from harness import main\n"
        "main.run(tiny_cell('vigor-serve-b8'), 3, 0.3, False, 'cpu')\n"
        "print(main.forbidden_modules())\n")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_no_program():
    proc = fresh(
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import reference.cvm, reference.train, reference.seeds\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        f"set({sorted(FORBIDDEN | {'ccvpe_tpu_torch'})!r})))\n")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"
