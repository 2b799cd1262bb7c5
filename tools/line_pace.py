"""What sets the pace of the straight SGM sweep (`sgm_line_kernel`).

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/line_pace.py [--stages 4 8 16] [--reps 10]

It builds the kernels once for each ring depth in ``--stages`` (scan
positions per warp, `-DSGM_LINE_STAGES=n`) and times, with CUDA events
around the launch alone and in turns across the builds, one straight
sweep at the shapes the paths give it:

- ``B2 add``: the main path's horizontal sweep, [2, 1440, 1696, 128]
  int16 scanned along W (each line's positions one run of bytes), adding
  into the accumulator in place (3 x the volume's bytes);
- ``B2 write``: the same writing the path cost (`aggregate_batch`'s first
  launch; 2 x the volume);
- ``B2 into, lines-adjacent``: row 2's entry point on its own layout,
  [2, 1696, 1440, 128] scanned along axis 1, acc + path into a new
  volume;
- ``B1 add``: the general path's horizontal sweep, [1, 1440, 1440, 128];
- ``B2 add, sgm_path_kernel``: the first case through the kernel that
  served it before, for reference.

Every run is held bit-equal to the plain version. It prints each median,
its time per scan step and the bytes rate, one JSON line with all of
them, and the card's name and power limit. It imports nothing of JAX.
"""

import argparse
import concurrent.futures
import ctypes
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
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("line_pace: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    with concurrent.futures.ThreadPoolExecutor(len(args.stages)) as pool:
        paths = pool.map(lambda n: cuda_agg.build(
            defines=(f"SGM_LINE_STAGES={n}",)), args.stages)
        libs = {n: cuda_agg.bind(ctypes.CDLL(p))
                for n, p in zip(args.stages, paths)}

    g = torch.Generator(device="cuda").manual_seed(5)

    def volume(shape):
        cost = torch.randint(0, 127, shape, generator=g, device="cuda",
                             dtype=torch.int16)
        inten = torch.randint(0, 256, shape[:-1], generator=g,
                              device="cuda", dtype=torch.int32)
        acc = torch.randint(0, 500, shape, generator=g, device="cuda",
                            dtype=torch.int16)
        return cost, inten, acc

    def plan(kernel, scan, mode, B):
        return [cuda_agg.Launch(kernel, scan, False, mode, (0,),
                                "fused_pass_batch", 0, B)]

    main_vol = volume((2, 1440, 1696, 128))
    adjacent = volume((2, 1696, 1440, 128))
    general = volume((1, 1440, 1440, 128))
    cases = {  # name: (volume, plan, steps, volumes of bytes moved)
        "B2 add": (main_vol, plan("line", 2, "add", 2), 1696, 3),
        "B2 write": (main_vol, plan("line", 2, "write", 2), 1696, 2),
        "B2 into, lines-adjacent": (adjacent, plan("line", 1, "into", 2),
                                    1696, 3),
        "B1 add": (general, plan("line", 2, "add", 1), 1440, 3),
        "B2 add, sgm_path_kernel": (main_vol, plan("path", 2, "add", 2),
                                    1696, 3),
    }
    runs = {}  # (case, stages) -> timed launch
    for name, (vol, pl, _, _) in cases.items():
        cost, inten, acc = vol
        acc = None if pl[0].mode == "write" else acc
        want = cuda_agg.plain_run_plan(pl, cost, inten, acc, P1, P2)
        for n in (args.stages if pl[0].kernel == "line" else args.stages[:1]):
            def run(pl=pl, cost=cost, inten=inten, acc=acc, want=want, n=n,
                    name=name):
                cuda_agg._lib = libs[n]
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                out = cuda_agg.run_plan(pl, cost, inten, acc, P1, P2,
                                        on_launch=lambda i: events[i].record())
                events[1].synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name}, {n} stages: differs from "
                                       "the plain version")
                return events[0].elapsed_time(events[1])
            runs[(name, n)] = run
        del want

    times = {key: [] for key in runs}
    for run in runs.values():  # warm-up
        run()
    for rep in range(args.reps):  # in turns, reversed every other round
        keys = list(runs) if rep % 2 == 0 else list(reversed(runs))
        for key in keys:
            times[key].append(runs[key]())

    out = {"card": card, "reps": args.reps, "cases": {}}
    for (name, n), ts in times.items():
        vol, pl, steps, volumes = cases[name]
        moved = volumes * vol[0].numel() * 2 + vol[1].numel() * 4
        ms = statistics.median(ts)
        label = name if pl[0].kernel == "path" else f"{name}, {n} stages"
        out["cases"][label] = {
            "ms": ms, "min_ms": min(ts), "max_ms": max(ts),
            "us_per_step": ms * 1e3 / steps, "tb_per_s": moved / ms / 1e9,
            "bound_ms": moved / PEAK_BYTES_PER_S * 1e3}
        print(f"{label:40s} {ms:8.3f} ms (min {min(ts):.3f}, max "
              f"{max(ts):.3f}), {ms * 1e3 / steps:6.3f} us per step, "
              f"{moved / ms / 1e9:5.2f} TB/s, bound "
              f"{moved / PEAK_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
