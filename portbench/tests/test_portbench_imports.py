"""No part of the harness imports JAX or the JAX package; the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "surface_multigrid_code_tpu"}
PORT = "surface_multigrid_code_torch"


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports, compared whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in ROOT.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)


def test_prefix_is_not_a_match():
    # the port's name begins with the JAX package's: compared whole, it is allowed
    assert PORT.startswith("surface_multigrid_code_") and PORT.split(".")[0] not in FORBIDDEN


def test_a_rehearsal_loads_no_jax():
    """A CPU rehearsal of a run, in a fresh process, leaves no forbidden
    module in ``sys.modules`` (the check the run makes itself)."""
    code = (
        "import torch, sys\n"
        "from conftest import small_cell, SOLVE\n"
        "from portbench.lib import cache\n"
        "import pathlib, tempfile\n"
        "cache.CACHE_DIR = pathlib.Path(tempfile.mkdtemp()) / 'cache'\n"
        "from portbench import run\n"
        "bench, w, c = small_cell('ico9_poisson.c3', **SOLVE)\n"
        "out = run.run_cell(bench, 'ico9_poisson.c3', w, c, 5, 0.5, False, torch.device('cpu'))\n"
        "assert out is not None and out['correct'], out\n"
        "assert 'surface_multigrid_code_torch' in sys.modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(run.FORBIDDEN)))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).parent,
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(ROOT.parent)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
