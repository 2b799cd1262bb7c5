"""Cells at a size that a CPU test run holds, with limits for that size.

The limits of the real configurations hold at their own sizes; at these
sizes the optimizer's depth maps are coarser, so the tests hold the sound
program to limits read from CPU runs at these sizes (see each entry), and
the control and every planted fault must fail them.
"""

from __future__ import annotations

import copy

import torch

from benchmarks import run

# dim 96 (pair) and 160 x 120 photos (scan): sound runs read depth_err
# up to 1.72e-3 and 5.4e-3 on the CPU (3 seeds each), sgm_mismatch 0 and
# opt_gap 0 (the CPU runs the reference optimizer bit for bit as the port).
# Each compares the numbers that its configuration compares.
LIMITS = {"rect2mp": {"sgm_mismatch": 0.001, "opt_gap": 1e-6,
                      "depth_err": 0.004},
          "dtu49": {"sgm_mismatch": 0.001, "opt_gap": 1e-6}}
CPU = torch.device("cpu")


def cell(name: str) -> tuple:
    """(bench, cell, config, traffic) of a cell, cut to the test size."""
    bench = run.load_benchmark()
    c, config, traffic = run.find_cell(bench, name)
    config = copy.deepcopy(config)
    if config["kind"] == "pair":
        config["scene"]["dim"] = 96
    else:
        config["scene"].update(photo_size=[160, 120], views=8, cols=4)
        config["first_view"] = 4
    config["limits"] = dict(LIMITS[config["name"]])
    return bench, c, config, traffic


def run_tiny(name: str, seed: int = 2**31 + 7, trace: bool = False) -> dict:
    """One run of a tiny cell on the CPU (one request in the window)."""
    import time

    bench, c, config, traffic = cell(name)
    return run.run_cell(c, config, traffic, seed, 0.0, trace, CPU, bench,
                        {}, time.perf_counter())
