"""Benchmark: depth-map reconstruction throughput of one ~2 MP view (port
of the JAX repository's `bench.py`).

A warm-up pass, then the median, min and max MP/s over
``SMVS_BENCH_PASSES`` passes of `bench_main.run_once` (base mode, one
neighbor), then the same for `bench_main.run_shading_once` (the
shading-aware flagship, two neighbors). MP/s is ``dim^2 / (t_sgm +
t_opt)``, host clock around work that ends in a device synchronize.
``vs_baseline`` divides by the reference C++ pipeline's single-thread
MP/s on a CPU on the same scenes (`baseline/BASELINE_MEASURED.json`).

Prints ONE JSON line with the JAX driver's keys and ``device``; logs to
stderr. Env: SMVS_BENCH_DIM (1440), SMVS_BENCH_MIN_SCALE (2),
SMVS_BENCH_PASSES (3). Runs on the GPU unless ``--device cpu``:

    python -m smvs_tpu_torch.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import torch

from smvs_tpu_torch.bench_main import run_once, run_shading_once
from smvs_tpu_torch.device import device_name, resolve_device

BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "baseline", "BASELINE_MEASURED.json")
# The JAX driver's estimate when the measurement file is missing: 2 MP in
# 60 s on one CPU thread.
FALLBACK_CPU_MPS = 0.033


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def baseline_mps(key: str) -> float | None:
    """``mps_single_thread`` of one entry of the measured baseline
    ("result": base mode, "shading_flagship": ``-S``), None without it."""
    try:
        with open(BASELINE_PATH) as f:
            return float(json.load(f)[key]["mps_single_thread"])
    except (OSError, KeyError, ValueError):
        return None


def _measure(tag, fn, dim, min_scale, passes):
    """Median/min/max MP/s over ``passes`` silent passes of
    ``fn(dim, min_scale, verbose=False)`` -> (t_sgm, t_opt, coverage,
    median_rel_err); coverage and error of the last pass."""
    mp = dim * dim / 1e6
    mps, cov, err = [], None, None
    for i in range(passes):
        t_sgm, t_opt, cov, err = fn(dim, min_scale, verbose=False)
        mps.append(mp / (t_sgm + t_opt))
        log(f"{tag} pass {i + 1}/{passes}: sgm={t_sgm:.2f}s "
            f"opt={t_opt:.2f}s -> {mps[-1]:.3f} MP/s "
            f"(coverage={cov:.1%} median_err={err:.5f})")
    mps.sort()
    return {
        "mps": round(mps[len(mps) // 2], 4),
        "mps_min": round(mps[0], 4),
        "mps_max": round(mps[-1], 4),
        "passes": passes,
        "coverage": round(cov, 4),
        "median_rel_err": round(err, 6),
    }


def run(dim: int = 1440, min_scale: int = 2, passes: int = 3,
        device: str | torch.device | None = None) -> dict:
    """The benchmark's result dict (what `main` prints)."""
    dev = resolve_device(device)
    name = device_name(dev)
    log(f"bench: device={name} dim={dim} min_scale={min_scale}")
    res = {}
    for key, fn, nbrs in (("base", run_once, 1),
                          ("shading_flagship", run_shading_once, 2)):
        fn = functools.partial(fn, device=dev)
        fn(dim, min_scale)  # warm-up
        res[key] = _measure(key, fn, dim, min_scale, passes)
        res[key]["neighbors"] = nbrs
        log(f"{key}: {res[key]}")
    shading = baseline_mps("shading_flagship")
    res["shading_flagship"]["vs_baseline"] = (
        None if not shading
        else round(res["shading_flagship"]["mps"] / shading, 2))
    mps = res["base"]["mps"]
    return {
        "metric": "depth_map_throughput",
        "value": mps,
        "unit": "MP/s",
        "vs_baseline": round(
            mps / (baseline_mps("result") or FALLBACK_CPU_MPS), 2),
        "base": res["base"],
        "shading_flagship": res["shading_flagship"],
        "device": name,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; \"cpu\" to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    print(json.dumps(run(
        dim=int(os.environ.get("SMVS_BENCH_DIM", "1440")),
        min_scale=int(os.environ.get("SMVS_BENCH_MIN_SCALE", "2")),
        passes=int(os.environ.get("SMVS_BENCH_PASSES", "3")),
        device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
