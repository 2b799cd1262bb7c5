"""Row 3's vertical pair on the card: the two-walk form of the vertical
sweep kernel against another checkout's route, in turns.

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/bidir_pace.py [--root PARENT] [--reps 10]
        [--lines 3 4 5 6 7 8]

``--root`` is a second checkout (a parent commit unpacked with `git
archive`), loaded beside this one as `tools/deep_pace.py` loads it, its
kernels built from its own source. The tool prints ptxas' registers and
spills of every form of both trees' kernels (and fails where a two-walk
form of `sgm_sweep3_kernel` spills), then times with CUDA events, median of
``--reps`` runs after a warm-up, each tree in turns (this, parent,
parent, this), every run bit-equal to the plain version:

- `fused_pass_bidir` with shifts (0, 1, -1) (this tree: one launch of
  `sgm_sweep3_kernel`'s two-walk form) and (0,) (two `sgm_line_kernel`
  launches in both) at [1440, 1440, 128] and [640, 640, 128];
- `aggregate` at both shapes, each launch timed too, so that its
  horizontal pair (two `sgm_line_kernel` launches) is read beside its
  bytes floor;
- the lines-a-block probe at both shapes: the vertical pair as the two
  one-walk launches of 16 lines a block, and as one two-walk launch of
  each of ``--lines`` lines a block whose blocks are all resident;
- the `aggregate_batch` probe on the main path's [2, 1440, 1696, 128]
  volume (`chip_smoke.py`'s phase 3: seed 1234, the INVALID band): its
  plan (row 1's two one-walk sweeps over both problems) against the same
  horizontal launches followed by one two-walk launch per problem, with
  the result's checksum.

``--phases`` runs instead `chip_smoke.py`'s kernel phases 3-4 of this
tree and of ``--root`` (each a process of its own importing that tree's
`chip_smoke`: build, rows 1-2 at the rectified path's shapes, rows 3-5 at
the general path's), in turns (parent, this, this, parent), and prints
each run's kernel times and their medians by tree.

Beside each time: the entry point's bound (its bytes: cost and
accumulator read once, result written once, at 3.35 TB/s) and each plan's
bytes floor (`cuda_agg.plan_bytes`, and the copy of acc where the plan adds
into one). One JSON line with all of it, and the card's name and power
limit. It imports nothing of JAX.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import deep_pace  # noqa: E402
from smvs_tpu_torch.sgm import cuda_agg  # noqa: E402
from smvs_tpu_torch.sgm.stereo import INVALID_COST  # noqa: E402

P1, P2 = deep_pace.P1, deep_pace.P2
PEAK_BYTES_PER_S = deep_pace.PEAK_BYTES_PER_S
D = 128
SHAPES = (1440, 640)  # [hw, hw, 128] problems
BATCH_SHAPE = (2, 1440, 1696, 128)  # the main path's volume
BATCH_W = 1440  # problem 0's width before the INVALID band


def ms_of(n_bytes: int) -> float:
    return n_bytes / PEAK_BYTES_PER_S * 1e3


def floor_ms(plan, cost, acc) -> float:
    """The plan's bytes floor, with the copy of acc (read and written)
    where its first launch adds into one."""
    copy = 2 * acc.numel() * 2 if acc is not None and \
        plan[0].mode == "add" else 0
    return ms_of(cuda_agg.plan_bytes(plan, tuple(cost.shape)) + copy)


def compare(label: str, plans: dict, cost, inten, acc, reps: int,
            aggs: dict) -> dict:
    """Each of ``plans`` (name -> plan, run through ``aggs[name]``, this
    tree's `cuda_agg` unless named) in turns, every run bit-equal to the
    plain version of the first; medians, per-launch medians and floors."""
    first = next(iter(plans.values()))
    want = cuda_agg.plain_run_plan(first, cost, inten, acc, P1, P2)
    runs = {k: (lambda plan=plan, agg=aggs.get(k, cuda_agg):
                deep_pace.run_timed(plan, cost, inten, acc, agg))
            for k, plan in plans.items()}
    times = deep_pace.in_turns(runs, want, reps, label)
    out = {"checksum": int(want.to(torch.int64).sum())}
    for k, plan in plans.items():
        out[k] = {"ms": times[k]["ms"], "launch_ms": times[k]["launch_ms"],
                  "launches": [cuda_agg.KERNELS[ln.kernel] +
                               (f" ({ln.lines} lines)" if ln.lines else "")
                               for ln in plan],
                  "floor_ms": floor_ms(plan, cost, acc)}
    print(f"{label}: " + "; ".join(
        f"{k} {v['ms']:.3f} ms ({len(v['launches'])} launches, floor "
        f"{v['floor_ms']:.3f})" for k, v in out.items() if k != "checksum")
        + "; bit-equal on every run", flush=True)
    del want
    return out


def seeded(shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cost = torch.randint(0, 127, shape, generator=g, device="cuda",
                         dtype=torch.int16)
    inten = torch.randint(0, 256, shape[:-1], generator=g, device="cuda",
                          dtype=torch.int32)
    acc = torch.randint(0, 500, shape, generator=g, device="cuda",
                        dtype=torch.int16)
    return cost, inten, acc


def pair_route(hw: int, reps: int, parent, lines_probe: list) -> dict:
    """The entry points and the lines-a-block probe at [hw, hw, 128]."""
    cost, inten, acc = seeded((1, hw, hw, D), 1700 + hw)
    n = cost.numel()
    res = {"shape": [hw, hw, D],
           "bound_ms": {"fused_pass_bidir": ms_of(6 * n + 4 * (n // D)),
                        "aggregate": ms_of(4 * n + 4 * (n // D))}}
    aggs = {"parent": parent}
    for shifts in ((0, 1, -1), (0,)):
        plans = {"this": cuda_agg.plan_route(
            "fused_pass_bidir", 1, hw, shifts=shifts,
            **cuda_agg.plan_geometry(cost))}
        if parent is not None:
            plans["parent"] = parent.plan_route(
                "fused_pass_bidir", 1, hw, shifts=shifts,
                **parent.plan_geometry(cost))
        res[f"fused_pass_bidir {shifts}"] = compare(
            f"fused_pass_bidir {shifts} [{hw}, {hw}, {D}]", plans, cost,
            inten, acc, reps, aggs)
    plans = {"this": cuda_agg.plan_route("aggregate", 1, hw,
                                         **cuda_agg.plan_geometry(cost))}
    if parent is not None:
        plans["parent"] = parent.plan_route("aggregate", 1, hw,
                                            **parent.plan_geometry(cost))
    agg = compare(f"aggregate [{hw}, {hw}, {D}]", plans, cost, inten, None,
                  reps, aggs)
    # The horizontal pair: sgm_line_kernel writing, then adding.
    line = agg["this"]["launch_ms"][:2]
    floor = ms_of(5 * 2 * n + 2 * 4 * (n // D))
    agg["line_pair"] = {"ms": sum(line), "launch_ms": line,
                        "floor_ms": floor, "share_of_floor": floor /
                        sum(line)}
    print(f"  aggregate's horizontal pair [{hw}, {hw}, {D}]: {sum(line):.3f}"
          f" ms, floor {floor:.3f} ms ({floor / sum(line):.0%})", flush=True)
    res["aggregate"] = agg
    # Lines a block: the one-walk pair, and the two-walk form at each
    # lines count whose blocks are all resident.
    L = cuda_agg.Launch
    probe = {"one walk, 16 lines, 2 launches": [
        L("sweep3", 1, r, "add", (0, 1, -1), "fused_pass_bidir", 0, 1)
        for r in (False, True)]}
    for lines in lines_probe:
        _, held = cuda_agg.bidir_geometry(cost.device, D, lines)
        if -(-hw // lines) <= held:
            probe[f"two walks, {lines} lines"] = [
                L("sweep3_bidir", 1, False, "add", (0, 1, -1),
                  "fused_pass_bidir", 0, 1, lines)]
        else:
            print(f"  two walks, {lines} lines: {-(-hw // lines)} blocks, "
                  f"{held} resident; not timed", flush=True)
    res["lines_probe"] = compare(f"lines a block [{hw}, {hw}, {D}]", probe,
                                 cost, inten, acc, reps, {})
    return res


def batch_probe(reps: int, parent) -> dict:
    """`aggregate_batch`'s vertical pair on the main path's volume: row
    1's route against one two-walk launch per problem."""
    g = torch.Generator(device="cuda").manual_seed(1234)
    cost = torch.randint(0, 127, BATCH_SHAPE, generator=g, device="cuda",
                         dtype=torch.int16)
    inten = torch.randint(0, 256, BATCH_SHAPE[:-1], generator=g,
                          device="cuda", dtype=torch.int32)
    cost[0, :, BATCH_W:] = INVALID_COST
    inten[0, :, BATCH_W:] = 0
    W = BATCH_SHAPE[2]
    plan = cuda_agg.plan_route("aggregate_batch", 2, W,
                               **cuda_agg.plan_geometry(cost))
    sms = torch.cuda.get_device_properties(cost.device).multi_processor_count
    lines = cuda_agg.bidir_lines(W, sms)
    _, held = cuda_agg.bidir_geometry(cost.device, D, lines)
    if -(-W // lines) > held:
        return {"skipped": f"{-(-W // lines)} blocks, {held} resident"}
    pairs = plan[:2] + [cuda_agg.Launch("sweep3_bidir", 1, False, "add",
                                        (0, 1, -1), "fused_pass", b, 1,
                                        lines) for b in (0, 1)]
    plans = {"this": plan, "two walks per problem": pairs}
    aggs = {}
    if parent is not None:
        plans["parent"] = parent.plan_route("aggregate_batch", 2, W,
                                            **parent.plan_geometry(cost))
        aggs["parent"] = parent
    out = compare(f"aggregate_batch {list(BATCH_SHAPE)}", plans, cost,
                  inten, None, reps, aggs)
    n = cost.numel()
    out["bound_ms"] = ms_of(4 * n + 4 * (n // D))
    return out


# One run of a tree's kernel phases: `chip_smoke.py`'s phases 3-4 (the
# tree's root is the first argument), printed as one JSON line.
PHASES = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
c.phase_build()
rows = c.phase_kernel_rectified()
rows.update(c.phase_kernel_general())
print("PHASES " + json.dumps(rows, default=str), flush=True)
"""


def phase_times(rows: dict) -> dict:
    """The kernel times of one run of phases 3-4, by name."""
    out = {f"{row} {list(r['shape'])}": r["ms"] for row, r in rows.items()}
    out["aggregate_batch"] = rows["fused_pass_batch"]["aggregate_batch"]["ms"]
    out["aggregate [1440, 1440, 128]"] = \
        rows["fused_pass_bidir"]["aggregate"]["ms"]
    for k, v in rows["fused_pass_bidir"].get("by_shape", {}).items():
        for entry, r in v.items():
            out[f"{entry} {k}"] = r["ms"]
    for k, v in rows["scan_direction"]["shifts"].items():
        out[f"scan_direction shift {k}"] = v["ms"]
    line = rows["fused_pass_batch"]["line_against_path"]
    out["straight sweep, line kernel"] = line["line_ms"]
    out["straight sweep, path kernel"] = line["path_ms"]
    return out


def kernel_phases(root: str) -> dict:
    """Phases 3-4 of this tree and of ``root`` in turns (parent, this,
    this, parent); each run's times and the medians by tree."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = {"this": [], "parent": []}
    for name in ("parent", "this", "this", "parent"):
        tree = here if name == "this" else os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", PHASES, tree],
                              capture_output=True, text=True, timeout=1200,
                              cwd=tree)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("PHASES ")]
        if proc.returncode != 0 or not line:
            sys.exit(f"phases 3-4 of {tree} failed ({proc.returncode}):\n"
                     f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        times = phase_times(json.loads(line[0][len("PHASES "):]))
        runs[name].append(times)
        print(f"{name}: " + "; ".join(f"{k} {v:.3f}"
                                      for k, v in times.items()),
              flush=True)
    med = {name: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for name, rs in runs.items()}
    for k, v in med["this"].items():
        p = med["parent"].get(k)
        print(f"  {k}: this {v:.3f} ms" + (
            "" if p is None else f", parent {p:.3f} ms ({v / p:.0%})"),
            flush=True)
    return {"runs": runs, "median": med}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--root", default=None,
                    help="a second checkout timed in turns with this one")
    ap.add_argument("--lines", type=int, nargs="+",
                    default=[3, 4, 5, 6, 7, 8],
                    help="lines a block of the two-walk form to probe")
    ap.add_argument("--phases", action="store_true",
                    help="run chip_smoke.py's phases 3-4 of this tree and "
                    "of --root in turns instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bidir_pace: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.phases:
        if not args.root:
            sys.exit("bidir_pace: --phases needs --root")
        print(json.dumps({"card": card,
                          "phases": kernel_phases(args.root)}), flush=True)
        print(card, flush=True)
        return 0
    parent = deep_pace.load_root(args.root) if args.root else None
    res = {"card": card, "ptxas": deep_pace.build_report(cuda_agg)}
    print("\n".join(res["ptxas"]), flush=True)
    spills = [r for r in res["ptxas"] if r.startswith("sgm_sweep3_kernel<")
              and ",1>" in r and not re.search(r"stores 0 B, loads 0 B", r)]
    if parent is not None:
        res["root"] = os.path.abspath(args.root)
        res["root_ptxas"] = deep_pace.build_report(parent)
        print("the parent checkout's:\n" + "\n".join(res["root_ptxas"]),
              flush=True)
    for hw in SHAPES:
        res[f"{hw}"] = pair_route(hw, args.reps, parent, args.lines)
    res["aggregate_batch"] = batch_probe(args.reps, parent)
    print(json.dumps(res), flush=True)
    print(card, flush=True)
    if spills:
        print("sgm_sweep3_kernel spills:\n" + "\n".join(spills), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
