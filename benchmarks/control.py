"""Readings that the limits of ``correct`` are set from (not run by a run).

    python3 benchmarks/control.py --workload CELL --seeds 1 2 3 --seconds S \
        [--control-seeds 1 2 3]

For each seed, in one process: render the cell's inputs, run its requests
for ``--seconds`` as a run's window does, then read the numbers that
`check` compares for the program's outputs (the lower readings). For the
seeds also in ``--control-seeds``, read them too for the plain reference
put in the program's place one precision below the configuration's
(``control``: the SGM stage's float work in bfloat16, the reference
optimizer and the true depth with TF32 products), and for the program run
again over the same requests with TF32 on for matrix products and
convolutions (``program_tf32``: the port's device policy turned off, the
step a later change might take). ``opt_gap_at`` gives the gap at other
quantiles beside the one compared. Prints one JSON line per seed and
appends them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "benchmarks"):
    sys.path[0] = ROOT


def readings(cell, config, traffic, seed, seconds, device,
             control: bool = True) -> dict:
    """The program's numbers for one seed, and with ``control`` the
    control's and the program's with TF32."""
    import numpy as np

    from benchmarks import drivers
    from smvs_tpu_torch import device as policy
    from smvs_tpu_torch.utils.timing import host_reads

    drv = drivers.load(config["kind"])(config, traffic, seed, device)
    drv.render()
    drv.prepare()
    outputs, spans, k = [], drivers.Spans(), 0
    host_reads.clear()
    t0 = time.perf_counter()
    while True:
        outputs += drv.run(drv.requests[k % len(drv.requests)], spans)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    reads = (host_reads["cg"] + host_reads["newton"]) / len(outputs)
    out = {"cell": cell["name"], "seed": seed, "views": len(outputs),
           "host_reads_per_view": reads,
           "program": drv.check(outputs, np.random.default_rng(seed))}
    if control:
        out["control"] = drv.check(outputs, np.random.default_rng(seed),
                                   control=True)
        with drivers.tf32_on(policy):
            again = []
            for j in range(k):
                again += drv.run(drv.requests[j % len(drv.requests)], spans)
        out["program_tf32"] = drv.check(again, np.random.default_rng(seed))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmarks import run
    from smvs_tpu_torch.device import resolve_device

    bench = run.load_benchmark()
    cell, config, traffic = run.find_cell(bench, args.workload)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(device)}", file=sys.stderr)
    for seed in args.seeds:
        line = json.dumps(readings(cell, config, traffic, seed, args.seconds,
                                   device, seed in args.control_seeds))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
