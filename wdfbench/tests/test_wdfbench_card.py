"""On a card: every cell runs through the command's own entry at a small
size, comes out correct, and reports its metrics.  Skips without a CUDA
device (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from .conftest import REPO, cells


@pytest.mark.gpu
@pytest.mark.parametrize("workload", cells())
def test_cell_runs_on_the_card(small, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "wdfbench.run", "--workload", workload,
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "1"],
                         cwd=small, capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
    assert r["device"]["busy_s"] > 0 and r["metrics"], r
