"""Nothing under portbench/ imports JAX or the JAX package, comparing each
module's top-level name whole (``ba_tpu_torch`` begins with ``ba_tpu``),
and the reference, the inputs and the work counts import nothing of the
program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ba_tpu"}
FROZEN = ("reference", "inputs", "work", "metrics")


def _imports(source: str) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


SOURCES = sorted(PACKAGE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[p.relative_to(PACKAGE).as_posix()
                                               for p in SOURCES])
def test_no_jax(path):
    assert not _imports(path.read_text()) & FORBIDDEN


@pytest.mark.parametrize("sub", FROZEN)
def test_frozen_parts_import_nothing_of_the_program(sub):
    for path in (PACKAGE / sub).rglob("*.py"):
        assert "ba_tpu_torch" not in _imports(path.read_text()), path


def test_the_scan_compares_whole_names():
    found = _imports("import ba_tpu_torch.ops\nfrom ba_tpu_torch import obs\n")
    assert found == {"ba_tpu_torch"} and not found & FORBIDDEN
    assert _imports("import jax.numpy\nfrom ba_tpu.core import om\n") == {"jax", "ba_tpu"}


def test_a_run_loads_no_jax():
    """What a run imports -- the harness, every driver and so the port --
    leaves no JAX module in ``sys.modules`` (the run's own check)."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.'); from portbench import harness; "
            "[harness.load_driver(d) for d in ('pipeline_sweep', 'failover_sweep', "
            "'fused_signed_sweep')]; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
