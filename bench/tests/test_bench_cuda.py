"""Each cell end to end on the card, briefly (skips without one)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench import harness as H


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in H.load_manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run([sys.executable, str(H.BENCH / "run.py"), "--workload", cell,
                           "--seed", str(2**31 + 77), "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, cwd=H.ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
