"""Time the rectified main path and the shading-aware flagship of a
checkout on the card, with the optimizer's per-scale Newton steps and PCG
iterations.

Runs `bench_main.run_once(1440, 2)` (and with ``--shading``
`bench_main.run_shading_once(1440, 2)`) once to warm up (the kernels are
built at their first use), then ``--reps`` times, and prints one JSON
line per timed run: t_sgm and t_opt (seconds), MP/s, coverage, median
relative error against the analytic depth, and the optimizer's progress
lines (`iter k: S newton steps, P patches, C cg iterations` per scale).
``--root`` imports `smvs_tpu_torch` from another checkout (a parent commit
unpacked with `git archive`), so that two trees are compared in one call,
in turns (parent, change, change, parent):

    python tools/main_path_time.py [--root DIR] [--reps N] [--shading]
        [--aggregate]

``--aggregate`` also times the main path's SGM kernels alone:
`cuda_agg.aggregate_batch` on a seeded [2, 1440, 1696, 128] volume (the
shape and the INVALID band of `chip_smoke.py`'s phase 3), the median of
20 CUDA-event runs after a warm-up, with its launches by kernel and a
checksum of its result, so that two trees' kernels are compared bit for
bit as well as by time.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys


def _runs(bench_main, fn, dim: int, reps: int, label: str) -> None:
    fn(dim, 2, device="cuda")  # warm-up: builds the kernels
    for rep in range(reps):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            t_sgm, t_opt, cov, med = fn(dim, 2, device="cuda", verbose=True)
        print(json.dumps({
            "root": label, "path": fn.__name__, "rep": rep,
            "t_sgm": t_sgm, "t_opt": t_opt,
            "mp_per_s": dim * dim / 1e6 / (t_sgm + t_opt),
            "coverage": cov, "median_rel_err": med,
            "progress": [ln.strip() for ln in err.getvalue().splitlines()
                         if ln.strip().startswith(("iter", "###"))],
        }), flush=True)


def _aggregate(label: str) -> None:
    import torch

    from smvs_tpu_torch.sgm import cuda_agg
    from smvs_tpu_torch.sgm.stereo import INVALID_COST

    g = torch.Generator(device="cuda").manual_seed(1234)
    shape = (2, 1440, 1696, 128)
    cost = torch.randint(0, 127, shape, generator=g, device="cuda",
                         dtype=torch.int16)
    inten = torch.randint(0, 256, shape[:-1], generator=g, device="cuda",
                          dtype=torch.int32)
    cost[0, :, 1440:] = INVALID_COST
    inten[0, :, 1440:] = 0
    cuda_agg.reset_launches()
    out = cuda_agg.aggregate_batch(cost, inten, 6, 96)
    kernels = {k: v for k, v in cuda_agg.kernel_launches.items() if v}
    checksum = int(out.to(torch.int64).sum())
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cuda_agg.aggregate_batch(cost, inten, 6, 96)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    print(json.dumps({"root": label, "path": "aggregate_batch",
                      "shape": list(shape), "ms": times[len(times) // 2],
                      "kernels": kernels, "checksum": checksum}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--dim", type=int, default=1440)
    ap.add_argument("--shading", action="store_true")
    ap.add_argument("--aggregate", action="store_true",
                    help="also time aggregate_batch on the main path's "
                         "volume")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("main_path_time: no CUDA device; this runs on the GPU")
    from smvs_tpu_torch import bench_main

    label = os.path.basename(os.path.abspath(args.root))
    if args.aggregate:
        _aggregate(label)
    _runs(bench_main, bench_main.run_once, args.dim, args.reps, label)
    if args.shading:
        _runs(bench_main, bench_main.run_shading_once, args.dim, args.reps,
              label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
