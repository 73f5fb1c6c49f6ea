"""The command as the driver runs it.  On a machine without a card it
exits with 2 and prints no result; on the card (marked ``cuda``) each cell
runs a short window and comes out correct.

    python -m pytest portbench/tests/test_portbench_card.py -m cuda
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = ("om1_sweep.plain", "sm3_fused.tables", "om1_failover.crash")


def _run(cwd: Path, workload: str, seconds: str = "2") -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 17), "--seconds", seconds, "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_without_a_card_no_result(no_card):
    out = _run(ROOT, "om1_sweep.plain")
    assert out.returncode == 2 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = _run(tmp_path, "om1_sweep.plain")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(card, workload):
    out = _run(ROOT, workload)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
