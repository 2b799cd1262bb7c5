"""What the SGM sweeps beyond 128 depths cost on the card, against the
per-path route.

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/deep_pace.py [--reps 10] [--depths 513 1024 2048]
    python tools/deep_pace.py --depths 129 192 256 512

At [640, 640, D] int16 (the deep-plane shapes of `chip_smoke.py`) it
builds the kernels (printing ptxas' registers and spills of every
instantiation of `sgm_line_kernel`, `sgm_sweep3_kernel`,
`sgm_deep_sweep_kernel` and `sgm_path_kernel`, one line each) and times
`aggregate`'s plan with CUDA events:

- the plan `cuda_agg.plan_route` gives (two straight sweeps and two
  3-path sweeps, 4 launches: `sgm_line_kernel` and `sgm_sweep3_kernel`
  at 129-512 depths, `sgm_deep_sweep_kernel` beyond) against the same
  sums as one launch per path (`cuda_agg.per_path_plan`, 8 launches of
  `sgm_path_kernel` or `sgm_deep_kernel`, the route every sweep took
  before), in turns (new, old, old, new), each run bit-equal to the
  plain version;
- each launch of both plans on its own (the events between launches);

beside the bound (the 8-path sum's bytes: cost read once, result written
once) and each plan's bytes floor (`cuda_agg.plan_bytes`: every launch
reads its cost, its accumulator unless it writes, and writes its result).
It prints one JSON line with all of them and the card's name and power
limit. It imports nothing of JAX.
"""

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from smvs_tpu_torch.sgm import cuda_agg  # noqa: E402

P1, P2 = 6, 96
HW = 640
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def seeded(D: int):
    g = torch.Generator(device="cuda").manual_seed(600 + D)
    cost = torch.randint(0, 127, (1, HW, HW, D), generator=g, device="cuda",
                         dtype=torch.int16)
    inten = torch.randint(0, 256, (1, HW, HW), generator=g, device="cuda",
                          dtype=torch.int32)
    return cost, inten


def run_timed(plan, cost, inten):
    """(result, total ms, per-launch ms) of one run of ``plan``."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(plan) + 1)]
    out = cuda_agg.run_plan(plan, cost, inten, None, P1, P2,
                            on_launch=lambda i: events[i].record())
    events[-1].synchronize()
    per = [events[i].elapsed_time(events[i + 1]) for i in range(len(plan))]
    return out, events[0].elapsed_time(events[-1]), per


def ptxas_summary(report: str) -> list:
    """One line per compiled kernel of nvcc's ``-Xptxas -v`` report: its
    name and template arguments (mangled), registers, and spill bytes."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '[^']*?\d(sgm_[a-z0-9_]*?"
                      r"_kernel)I(\w*?)EEv", line)
        if m:
            args = re.sub(r"L[ib](\d+)E?", r"\1,", m.group(2)).rstrip(",")
            args = {"s": "int16,", "i": "int32,"}.get(args[:1], "") + \
                args.lstrip("si")
            name = f"{m.group(1)}<{args}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return rows


def probe(D: int, reps: int) -> dict:
    """Single 3-path launches at [640, 640, D] that tell the parts of a
    step apart: the plan's launch (adding into an accumulator), the same
    writing (no accumulator read), one diagonal alone, and 128 problems of
    5 lines each (one block apiece, the same lines a block, no hand-off
    between blocks). Each is held bit-equal to the plain sweep."""
    g = torch.Generator(device="cuda").manual_seed(900 + D)
    cost = torch.randint(0, 127, (1, HW, HW, D), generator=g, device="cuda",
                         dtype=torch.int16)
    inten = torch.randint(0, 256, (1, HW, HW), generator=g, device="cuda",
                          dtype=torch.int32)
    acc = torch.randint(0, 500, cost.shape, generator=g, device="cuda",
                        dtype=torch.int16)
    lines, _, sms = cuda_agg.deep_sweep_geometry(cost.device, D)
    (_, _, n), = cuda_agg.deep_sweep_chunks(1, HW, lines, sms)
    L = cuda_agg.Launch
    split = (cost.reshape(HW, 128, 5, D).transpose(0, 1).contiguous(),
             inten.reshape(HW, 128, 5).transpose(0, 1).contiguous())
    cases = {
        "add": ([L("deep_sweep", 1, False, "add", (0, 1, -1), "fused_pass",
                   0, 1, n)], cost, inten, acc),
        "write": ([L("deep_sweep", 1, False, "write", (0, 1, -1),
                     "fused_pass", 0, 1, n)], cost, inten, None),
        "+1 only": ([L("deep_sweep", 1, False, "add", (1,), "fused_pass", 0,
                       1, n)], cost, inten, acc),
        "128 x 5 lines": ([L("deep_sweep", 1, False, "write", (0, 1, -1),
                             "fused_pass", 0, 128, 5)], *split, None),
        "128 x 5 lines, +1 only": ([L("deep_sweep", 1, False, "write", (1,),
                                      "fused_pass", 0, 128, 5)], *split,
                                   None),
        "straight, 5 lines a block": ([L("deep_sweep", 1, False, "write",
                                         (0,), "fused_pass", 0, 1, 5)],
                                      cost, inten, None),
        "straight, 1 line a block": ([L("deep_sweep", 1, False, "write",
                                        (0,), "fused_pass", 0, 1, 1)],
                                     cost, inten, None),
    }
    out = {"lines": n}
    for name, (plan, c, i, a) in cases.items():
        want = cuda_agg.plain_run_plan(plan, c, i, a, P1, P2)
        ts = []
        for rep in range(reps + 1):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            got = cuda_agg.run_plan(plan, c, i, a, P1, P2,
                                    on_launch=lambda k: events[k].record())
            events[1].synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"D = {D} {name}: differs from plain")
            if rep:
                ts.append(events[0].elapsed_time(events[1]))
        out[name] = statistics.median(ts)
        print(f"probe D = {D} {name}: {out[name]:.3f} ms "
              f"({out[name] / HW * 1e3:.2f} us a step)", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--depths", type=int, nargs="+",
                    default=[513, 1024, 2048])
    ap.add_argument("--probe", action="store_true",
                    help="time single 3-path launches in variants that "
                    "tell a step's parts apart, and nothing else")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("deep_pace: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # ptxas reports only while it compiles: where the library is built
    # already, a copy under a define that the source does not read is.
    built = os.path.exists(cuda_agg.library_path())
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        cuda_agg.build(verbose=True,
                       defines=("SGM_PTXAS_REPORT=1",) if built else ())
    ptxas = ptxas_summary(report.getvalue())
    print("\n".join(ptxas), flush=True)
    res = {"card": card, "ptxas": ptxas, "depths": {}}
    if args.probe:
        res["probe"] = {D: probe(D, args.reps) for D in args.depths}
        print(json.dumps(res), flush=True)
        return 0
    for D in args.depths:
        cost, inten = seeded(D)
        geo = cuda_agg.plan_geometry(cost)
        new = cuda_agg.plan_route("aggregate", 1, HW, **geo)
        old = cuda_agg.per_path_plan(new, D)
        want = cuda_agg.plain_aggregate_batch(cost, inten, P1, P2).to(
            torch.int16)
        times = {"new": [], "old": []}
        per_launch = {"new": [], "old": []}
        for rep in range(2 * args.reps + 2):
            which = ("new", "old", "old", "new")[rep % 4]
            out, ms, per = run_timed(new if which == "new" else old, cost,
                                     inten)
            if not torch.equal(out, want):
                raise RuntimeError(f"D = {D}: the {which} route differs "
                                   "from the plain version")
            if rep >= 2:  # the first of each is a warm-up
                times[which].append(ms)
                per_launch[which].append(per)
            del out
        shape = tuple(cost.shape)
        n = cost.numel()
        bound = (2 * n + 4 * (n // D) + 2 * n) / PEAK_BYTES_PER_S * 1e3
        row = {
            "shape": list(shape),
            "plan": [(ln.kernel, ln.scan, ln.reverse, ln.mode,
                      list(ln.shifts), ln.lines) for ln in new],
            "new_ms": statistics.median(times["new"]),
            "old_ms": statistics.median(times["old"]),
            "new_launch_ms": [statistics.median(c)
                              for c in zip(*per_launch["new"])],
            "old_launch_ms": [statistics.median(c)
                              for c in zip(*per_launch["old"])],
            "bound_ms": bound,
            "new_floor_ms": cuda_agg.plan_bytes(new, shape)
            / PEAK_BYTES_PER_S * 1e3,
            "old_floor_ms": cuda_agg.plan_bytes(old, shape)
            / PEAK_BYTES_PER_S * 1e3,
        }
        res["depths"][D] = row
        print(f"D = {D}: new {row['new_ms']:.3f} ms ({len(new)} launches: "
              + ", ".join(f"{t:.3f}" for t in row["new_launch_ms"])
              + f"), per path {row['old_ms']:.3f} ms ({len(old)} launches: "
              + ", ".join(f"{t:.3f}" for t in row["old_launch_ms"]) + ");"
              f" floors {row['new_floor_ms']:.3f} / {row['old_floor_ms']:.3f}"
              f" ms, bound {bound:.4f} ms; bit-equal on every run",
              flush=True)
        del cost, inten, want
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
