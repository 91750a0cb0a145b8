"""What the harness and the reference load: no module whose top-level
name is jax, jaxlib, flax or the JAX package's, and nothing of
``benchmarks/``."""
import ast
import os
import subprocess
import sys

from esdbench.harness import FORBIDDEN
from esdbench.manifest import HERE


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for path in HERE.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        assert not set(_imports(path)) & set(FORBIDDEN), path
        assert "benchmarks/" not in path.read_text(), path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_a_built_program_loads_nothing_forbidden():
    code = (
        "import sys, tempfile, time, torch\n"
        "from pathlib import Path\n"
        "from esdbench._tiny import write_tiny, CELL\n"
        "from esdbench.harness import run_cell, loaded_forbidden\n"
        "root = write_tiny(Path(tempfile.mkdtemp()))\n"
        "run_cell(CELL, 3, 2.0, False, root=root, here=root,\n"
        "         t_start=time.perf_counter(), device='cpu')\n"
        "assert 'repro_torch' in sys.modules\n"
        "print('FOUND', loaded_forbidden())\n")
    root = HERE.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FOUND []" in res.stdout
