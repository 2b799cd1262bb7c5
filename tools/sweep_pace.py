"""What sets the pace of the vertical SGM sweep on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/sweep_pace.py [--reps 10]

At the main path's sweep shape, [1440, 1696, 128] int16 scanned along
the 1440 rows (one problem, as `fused_pass` takes it, and two, as
`aggregate_batch`'s vertical sweeps take them), it times with CUDA events:

- the 3-path sweep through `sgm_sweep3_kernel` (one launch) against the
  same sweep as three `sgm_path_kernel` launches, one per path (the route
  rows 1 and 4 took before the sweep kernel, and a problem wider than the
  resident blocks takes now), in turns, and holds the two bit-equal;
- `sgm_sweep3_kernel` with the straight path only (no block waits on
  another), one diagonal, and all three paths, to tell the blocks'
  per-step hand-off from the bytes and the arithmetic.

It prints each median, its time per scan step and the bytes rate it
reaches (cost and accumulator read once, accumulator written once), one
JSON line with all of them, and the card's name and power limit. It
imports nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from smvs_tpu_torch.sgm import cuda_agg  # noqa: E402

P1, P2 = 6, 96
SHAPE = (1440, 1696, 128)


def events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sweep_pace: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    g = torch.Generator(device="cuda").manual_seed(99)
    shape = (2,) + SHAPE
    cost = torch.randint(0, 127, shape, generator=g, device="cuda",
                         dtype=torch.int16)
    inten = torch.randint(0, 256, shape[:-1], generator=g, device="cuda",
                          dtype=torch.int32)
    acc = torch.randint(0, 500, shape, generator=g, device="cuda",
                        dtype=torch.int16)
    X = SHAPE[0]

    def sweep3(B, shifts):
        plan = [cuda_agg.Launch("sweep3", 1, False, "add", shifts,
                                "fused_pass", 0, B)]
        return lambda: cuda_agg.run_plan(plan, cost[:B], inten[:B], acc[:B],
                                         P1, P2)

    def per_path(B, shifts):
        plan = [cuda_agg.Launch("path", 1, False, "add", (s,),
                                "fused_pass", 0, B) for s in shifts]
        return lambda: cuda_agg.run_plan(plan, cost[:B], inten[:B], acc[:B],
                                         P1, P2)

    cases = {}
    for B in (1, 2):
        full = (0, 1, -1)
        if not torch.equal(sweep3(B, full)(), per_path(B, full)()):
            raise RuntimeError(f"B={B}: the two routes differ")
        cases[f"B{B} sweep3 (0, 1, -1)"] = sweep3(B, full)
        cases[f"B{B} per-path x3 (0, 1, -1)"] = per_path(B, full)
    for shifts in ((0,), (1,), (-1,), (0, 1)):
        cases[f"B1 sweep3 {shifts}"] = sweep3(1, shifts)

    times = {name: [] for name in cases}
    for fn in cases.values():  # warm-up, and the build
        fn()
    torch.cuda.synchronize()
    for rep in range(args.reps):  # in turns, reversed every other round
        names = list(cases) if rep % 2 == 0 else list(reversed(cases))
        for name in names:
            times[name].append(events_ms(cases[name]))

    out = {"card": card, "shape": list(SHAPE), "reps": args.reps,
           "cases": {}}
    for name, ts in times.items():
        B = int(name[1])
        ms = statistics.median(ts)
        moved = 3 * 2 * B * SHAPE[0] * SHAPE[1] * SHAPE[2]
        out["cases"][name] = {
            "ms": ms, "min_ms": min(ts), "max_ms": max(ts),
            "us_per_step": ms * 1e3 / X, "tb_per_s": moved / ms / 1e9}
        print(f"{name:28s} {ms:8.3f} ms (min {min(ts):.3f}, max "
              f"{max(ts):.3f}), {ms * 1e3 / X:6.3f} us per step, "
              f"{moved / ms / 1e9:5.2f} TB/s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
