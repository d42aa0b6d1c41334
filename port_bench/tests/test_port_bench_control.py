"""The control on the card: the reference in TF32 in the program's place
must come out not correct, at the cell's own size (a short window).
Skips without a CUDA device."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(card, cell):
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        cell, "--seed", "1234567", "--seconds", "2",
                        "--trace", "0", "--control", "tf32"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
