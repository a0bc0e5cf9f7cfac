"""One short run of every cell on the card (``python -m pytest edanbench
-m gpu`` on a machine with one); skipped without a card."""
import json
import subprocess
import sys

import pytest

from edanbench.conftest import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["polybench15-n20.suite", "hpcg-16x6.sweep"])
def test_a_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "edanbench/run.py", "--workload", cell, "--seed",
         "3000000001", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
