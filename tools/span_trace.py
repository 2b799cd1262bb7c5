"""The program's spans on the card, for one benchmark cell: what tracing
costs, and where a traced request's device time, launches and syncs sit.

    python tools/span_trace.py --workload dtu49.seq --seed 7 [--seconds 60]
        [--out spans.json]

Sets the cell up as `benchmarks/run.py` does (its configuration and
traffic from BENCHMARK.json, inputs from the seed, one warm-up request),
then:

1. the cost of tracing, for ``--seconds``: each request of the cell's
   cycle run twice in a row, once with spans off and once on (off first
   for even requests, on first for odd ones), each run timed to its end;
   ``depth_mps`` off and on (the input megapixels over the seconds of
   each side, `depth_mps`'s arithmetic), and the quartiles of the
   per-request ratio of the time on to the time off; and the host's cost
   of one empty span, on and off (a loop of them);
2. one request under `torch.profiler` (`tools/trace_spans.py`): the
   spans table (count, host, wall and device seconds, launches and syncs
   by span name, each inclusive), the share of device time launched
   inside a program span, the syncs by innermost span, the syncs and
   launches a view inside ``opt.view`` / ``opt.batch``, the request's
   `host_reads` by site, and the longest idle gaps labelled by span
   (and as the benchmark's breakdown labels them, ``bench_idle_gaps``).

Needs a card (exit 2 without one, as the benchmark). Prints the card's
name and power limit first, then one JSON line, also written to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")  # as the benchmark runs

import torch  # noqa: E402

from benchmarks import drivers, run  # noqa: E402
from smvs_tpu_torch.sgm import cuda_agg  # noqa: E402
from smvs_tpu_torch.utils import timing  # noqa: E402
from smvs_tpu_torch.utils.timing import host_reads  # noqa: E402
from tools import trace_spans as sp  # noqa: E402

OPT = ("opt.view", "opt.batch")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def timed(drv, request, on: bool) -> tuple:
    """(seconds, input megapixels) of one request, spans ``on`` or off."""
    timing.clear()
    (timing.enable if on else timing.disable)()
    try:
        t0 = time.perf_counter()
        out = drv.run(request, drivers.Spans())
        drivers.synchronize(drv.device)
        return time.perf_counter() - t0, sum(o["mp"] for o in out)
    finally:
        timing.disable()
        timing.clear()


def paired_cost(drv, seconds: float) -> dict:
    """Each request off and on in turns (off first for even ``k``) for
    ``seconds``: `depth_mps` of each side, the per-request ratio of the
    time on to the time off, and its median for each order; their
    geometric mean cancels what running second does to a request."""
    sides = {"off": [0.0, 0.0], "on": [0.0, 0.0]}  # seconds, megapixels
    runs, k, t0 = [], 1, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        request = drv.requests[k % len(drv.requests)]
        took = {}
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            dt, mp = timed(drv, request, on)
            side = "on" if on else "off"
            took[side] = dt
            sides[side][0] += dt
            sides[side][1] += mp
        runs.append([k, "off" if k % 2 == 0 else "on", took["off"],
                     took["on"]])
        k += 1
    ratios = [on / off for _, _, off, on in runs]
    mps = {side: mp / dt for side, (dt, mp) in sides.items()}
    out = {"off": mps["off"], "on": mps["on"],
           "on_vs_off": mps["on"] / mps["off"] - 1.0, "pairs": len(runs),
           "runs": runs}
    if len(ratios) > 1:
        out["time_ratio_quartiles"] = statistics.quantiles(ratios, n=4)
    by_order = {first: statistics.median(
        on / off for _, f, off, on in runs if f == first)
        for first in ("off", "on") if any(r[1] == first for r in runs)}
    out["time_ratio_median_by_first"] = by_order
    if len(by_order) == 2:
        out["time_ratio_order_free"] = math.sqrt(by_order["off"]
                                                 * by_order["on"])
    return out


def span_cost_ns(n: int = 200000) -> dict:
    """Nanoseconds of one empty ``with span(...)``, tracing off and on
    (no profiler running)."""
    out = {}
    for on in (False, True):
        timing.clear()
        (timing.enable if on else timing.disable)()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with timing.span("opt.update"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
        timing.disable()
    timing.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("span_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(f"card: {card()}", file=sys.stderr, flush=True)
    bench = run.load_benchmark()
    _, config, traffic = run.find_cell(bench, args.workload)
    cuda_agg.build()
    drv = drivers.load(config["kind"])(config, traffic, args.seed, dev)
    drv.render()
    drv.prepare()
    drv.run(drv.requests[0], drivers.Spans())
    drivers.synchronize(dev)

    result = {"workload": args.workload, "seed": args.seed, "card": card(),
              "torch": torch.__version__}
    result["depth_mps"] = paired_cost(drv, args.seconds)
    print("depth_mps " + json.dumps({k: v for k, v in result["depth_mps"]
                                     .items() if k != "runs"}),
          file=sys.stderr, flush=True)
    result["span_ns"] = span_cost_ns()

    host_reads.clear()
    out, red = sp.capture(lambda: drv.run(drv.requests[0], drivers.Spans()))
    views = len(out)
    table = red["spans"]
    base = red["trace"]
    result.update(
        traced_views=views, window_s=base.window_s, busy_s=base.busy_s,
        idle_share=1.0 - base.busy_s / base.window_s,
        device_op_s=red["device_op_s"], attributed_s=red["attributed_s"],
        attributed_share=red["attributed_s"] / red["device_op_s"]
        if red["device_op_s"] else None,
        host_reads=dict(host_reads),
        host_reads_per_view=(host_reads["cg"] + host_reads["newton"])
        / views,
        opt_syncs_per_view=sp.per_span(table, OPT, "syncs") / views,
        opt_launches_per_view=sp.per_span(table, OPT, "launches") / views,
        spans_per_view=sum(r["count"] for r in table.values()) / views,
        inner_syncs=red["inner_syncs"], idle_gaps=red["idle_gaps"],
        bench_idle_gaps=base.longest_gaps,
        spans=table, top_ops=base.kernel_s and sorted(
            base.kernel_s.items(), key=lambda kv: -kv[1])[:10])
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
