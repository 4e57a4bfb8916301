"""A run without a card exits non-zero and prints no result; it never
falls back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, "-m", "synbench.run", "--workload", "human2_1g.div01",
         "--seed", str((1 << 31) + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr
