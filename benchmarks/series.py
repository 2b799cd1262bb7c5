"""Runs of one cell, one process each, and the spread of their metrics.

    python3 benchmarks/series.py --workload CELL --seeds 1 2 3 \
        --seconds S [--trace 0|1] [--sets 2] [--out FILE.jsonl]

Runs `run.py` once per seed (each set runs every seed, in order), keeps
each run's last line (and the end of its standard error where it failed)
in ``--out``, and prints each metric's median and its spread per set: the
distance between the first and third quartile (`statistics.quantiles`,
n=4) as a share of the median, from which a bound is set.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values) -> tuple:
    """(median, (q3 - q1) / median) of at least two values."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for s in range(args.sets):
        for seed in args.seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.join(ROOT, "benchmarks", "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            rec = {"set": s, "seed": seed, "rc": proc.returncode,
                   "wall_s": wall}
            lines = proc.stdout.strip().splitlines()
            try:
                rec["result"] = json.loads(lines[-1])
            except (IndexError, ValueError):
                rec["stderr"] = proc.stderr[-4000:]
            rec["setup"] = [ln for ln in proc.stderr.splitlines()
                            if ln.startswith(("setup ", "window", "check",
                                              "request"))]
            runs.append(rec)
            print(json.dumps(rec), flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    for s in range(args.sets):
        ok = [r["result"] for r in runs if r["set"] == s and "result" in r]
        names = sorted({m for r in ok for m in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in ok
                    if name in r["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"set {s} {name}: median {med!r} spread {sp!r} "
                      f"({len(vals)} runs)", flush=True)
        print(f"set {s}: {sum(r['correct'] for r in ok)} of {len(ok)} "
              f"correct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
