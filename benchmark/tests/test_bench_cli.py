"""The command's contract where there is no card: a non-zero exit and no
result on standard output, never a fall back to the CPU."""
import os
import subprocess
import sys

import pytest

from conftest import ROOT


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    proc = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         "episode-single", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
