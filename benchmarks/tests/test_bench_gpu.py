"""A short run of every cell on the card (skips without one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmarks import run


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  run.load_benchmark()["workloads"]])
def test_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "1", "--trace", "1"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
