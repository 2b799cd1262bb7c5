"""A run's last line, and the runs that must print none."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmarks import run
from benchmarks.tests import tiny


def test_last_line_keys_untraced():
    res = tiny.run_tiny("rect2mp.seq")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["failed"] == 0
    assert set(res["metrics"]) == {"depth_mps", "setup_s"}  # no card peak
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == {"sgm_mismatch", "opt_gap", "depth_err"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res, allow_nan=False)


def test_last_line_keys_traced():
    res = tiny.run_tiny("rect2mp.seq", trace=True)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    assert {"sgm_s_per_view", "opt_s_per_view",
            "host_reads_per_view"} <= set(res["metrics"])
    assert "depth_mps" not in res["metrics"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without")
    assert run.main(["--workload", "rect2mp.seq", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits with another code than 0 and prints no result."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "benchmarks"),
                    tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "rect2mp.seq",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
