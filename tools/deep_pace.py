"""What the SGM sweeps beyond 128 depths cost on the card, against the
per-path route, and what `sgm_path_kernel` costs against another
checkout's.

Run from the repository root on a machine with an NVIDIA GPU:

    python tools/deep_pace.py [--reps 10] [--depths 513 1024 2048]
    python tools/deep_pace.py --depths 129 192 256 512 [--root PARENT]
    python tools/deep_pace.py --row5 [--depths 256 512 2048] [--root PARENT]
    python tools/deep_pace.py --probe-deep [--root PARENT] [--knobs ...]

At [640, 640, D] int16 (the deep-plane shapes of `chip_smoke.py`) it
builds the kernels (printing ptxas' registers and spills of every
instantiation of `sgm_line_kernel`, `sgm_sweep3_kernel`,
`sgm_deep_sweep_kernel`, `sgm_path_kernel` and `sgm_deep_kernel`, one line
each) and times
`aggregate`'s plan with CUDA events:

- the plan `cuda_agg.plan_route` gives (two straight sweeps and two
  3-path sweeps, 4 launches: `sgm_line_kernel` and `sgm_sweep3_kernel`
  at 129-512 depths, `sgm_deep_sweep_kernel` beyond) against the same
  sums as one launch per path (`cuda_agg.per_path_plan`, 8 launches of
  `sgm_path_kernel` or `sgm_deep_kernel`), in turns (new, old, old, new),
  each run bit-equal to the plain version;
- each launch of both plans on its own (the events between launches);

beside the bound (the 8-path sum's bytes: cost read once, result written
once) and each plan's bytes floor (`cuda_agg.plan_bytes`: every launch
reads its cost, its accumulator unless it writes, and writes its result).

``--root DIR`` loads a second checkout's `smvs_tpu_torch/sgm/cuda_agg.py`
(a parent commit unpacked with `git archive`) beside this one, builds its
kernels from its own source (its ptxas report too) and times its per-path
route in the same turns (new, old, parent, parent, old, new), so that two
trees' one-path-per-launch kernels are compared in one process on one
card, bit for bit as well as by time.

``--probe-deep`` builds `sgm_deep_kernel` with other knobs (warps a chain,
ring bytes, staged stores, the ring's fill, the kind of barrier;
`DEEP_VARIANTS`), prints
each build's ptxas registers and spills for the kernel, and times its
launches in turns with the ``--root`` checkout's: row 5 at [640, 640, D],
D = 513, 1024 and 2048, a diagonal adding in place at D = 1024, and the
per-path route of `aggregate` at D = 513.

``--row5`` times Pallas row 5 instead, `scan_direction`'s one launch
(`sgm_path_kernel` to 512 depths, `sgm_deep_kernel` beyond) on int32
costs above 2^15: at [1440, 1440, 128] with shifts 0, 1 and -1 and at
[640, 640, D] for each of ``--depths`` with shift 1, each launch bit-equal
to the plain version, in turns with the ``--root`` checkout's (this,
parent, parent, this), beside its bound (the int32 cost read once, the
path written once, the intensities read once).

It prints one JSON line with all of them and the card's name and power
limit. It imports nothing of JAX.
"""

import argparse
import concurrent.futures
import contextlib
import ctypes
import importlib.util
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


def run_timed(plan, cost, inten, acc=None, agg=cuda_agg):
    """(result, total ms, per-launch ms) of one run of ``plan`` through
    ``agg`` (this tree's `cuda_agg` or another checkout's)."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(plan) + 1)]
    out = agg.run_plan(plan, cost, inten, acc, P1, P2,
                       on_launch=lambda i: events[i].record())
    events[-1].synchronize()
    per = [events[i].elapsed_time(events[i + 1]) for i in range(len(plan))]
    return out, events[0].elapsed_time(events[-1]), per


def load_root(root: str):
    """Another checkout's `cuda_agg` module, under its own name: its
    kernels are built from its own source into its own build directory."""
    path = os.path.join(os.path.abspath(root), "smvs_tpu_torch", "sgm",
                        "cuda_agg.py")
    spec = importlib.util.spec_from_file_location("root_cuda_agg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_report(agg) -> list:
    """Builds ``agg``'s kernels and returns ptxas' lines for them. ptxas
    reports only while it compiles: where the library is built already, a
    copy under a define that the source does not read is."""
    built = os.path.exists(agg.library_path())
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        agg.build(verbose=True,
                  defines=("SGM_PTXAS_REPORT=1",) if built else ())
    return ptxas_summary(report.getvalue())


def in_turns(runs: dict, want, reps: int, label: str) -> dict:
    """Each of ``runs`` (name -> function returning (result, total ms,
    per-launch ms)) ``reps`` times after a warm-up, in turns (the order,
    then reversed, ...), every result equal to ``want``; the medians."""
    names = list(runs)
    order = names + names[::-1]
    times = {k: [] for k in names}
    per_launch = {k: [] for k in names}
    for rep in range(reps * len(names) + len(names)):
        k = order[rep % len(order)]
        out, ms, per = runs[k]()
        if not torch.equal(out, want):
            raise RuntimeError(f"{label}: {k} differs from the plain "
                               "version")
        if rep >= len(names):  # the first of each is a warm-up
            times[k].append(ms)
            per_launch[k].append(per)
        del out
    return {k: {"ms": statistics.median(times[k]),
                "launch_ms": [statistics.median(c)
                              for c in zip(*per_launch[k])]}
            for k in names}


def row5(shapes: list, reps: int, parent) -> dict:
    """Row 5 (`scan_direction`, one launch) at each (shape, shift) of
    ``shapes`` on int32 costs above 2^15, this tree's kernel and (if
    given) the parent checkout's in turns, each run bit-equal to plain."""
    res = {}
    for (shape, shift) in shapes:
        L, X, D = shape
        g = torch.Generator(device="cuda").manual_seed(500 + D + shift)
        cost = torch.randint(0, 127, (1, L, X, D), generator=g,
                             device="cuda", dtype=torch.int32) * 300
        inten = torch.randint(0, 256, (1, L, X), generator=g, device="cuda",
                              dtype=torch.int32)
        runs = {}
        for name, agg in (("this", cuda_agg), ("parent", parent)):
            if agg is None:
                continue
            plan = [agg.Launch(agg.path_kernel(D), 2, False, "write",
                               (shift,), "scan_direction", 0, 1)]
            runs[name] = (lambda plan=plan, agg=agg:
                          run_timed(plan, cost, inten, None, agg))
        want = cuda_agg.plain_scan_direction(cost[0], inten[0], shift, P1,
                                             P2)[None]
        times = in_turns(runs, want, reps, f"row 5 {shape} shift {shift}")
        n = cost.numel()
        bound = (8 * n + 4 * (n // D)) / PEAK_BYTES_PER_S * 1e3
        row = {"shape": list(shape), "shift": shift, "bound_ms": bound,
               "kernel": cuda_agg.KERNELS[cuda_agg.path_kernel(D)]}
        for k, v in times.items():
            row[f"{k}_ms"] = v["ms"]
            row[f"{k}_share_of_bound"] = bound / v["ms"]
        res[f"{list(shape)} shift {shift}"] = row
        print(f"row 5 {list(shape)} shift {shift} ({row['kernel']}): "
              + ", ".join(f"{k} {v['ms']:.3f} ms ({bound / v['ms']:.0%} of "
                          "bound)" for k, v in times.items())
              + f"; bound {bound:.4f} ms; bit-equal on every run",
              flush=True)
        del cost, inten, want
        torch.cuda.empty_cache()
    return res


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


# `sgm_path_kernel` built with other knobs (the -D defines at the head of
# `csrc/sgm_agg.cu`): warps a block, ring bytes a warp, and whether a
# lane's run wider than 16 bytes goes out through the ring stage
# (consecutive 16-byte pieces); for --probe-path. Each build sets every
# knob; the first is the kernel before the probes, (1, 4096, 1) the one
# kept.
PATH_KNOBS = [  # (warps, ring bytes, stage out)
    (4, 8192, 0), (4, 4096, 0), (8, 4096, 0), (2, 8192, 0), (2, 16384, 0),
    (1, 32768, 0), (4, 8192, 1), (2, 16384, 1), (2, 8192, 1), (1, 4096, 1),
    (1, 8192, 1), (1, 16384, 1), (1, 32768, 1)]
PATH_VARIANTS = {
    f"{w} warps, ring {b // 1024} KB, stage {st}": (
        f"SGM_PATH_WARPS={w}", f"SGM_PATH_RING_BYTES={b}",
        f"SGM_PATH_STAGE_OUT={st}")
    for w, b, st in PATH_KNOBS}


def probe_path(reps: int, parent, knobs=None) -> dict:
    """Single `sgm_path_kernel` launches in every build of PATH_VARIANTS
    named in ``knobs`` (all by default; and the parent checkout's, if
    given), in turns, each bit-equal to plain: row 5 at [1440, 1440, 128]
    shift 0 and [640, 640, D] shift 1 (D = 256, 512; 512 with shift 0
    too), a diagonal adding into an int16 accumulator at [640, 640, D] and
    [1440, 1440, 256], and the in-place straight sweep of `chip_smoke.py`'s
    phase 3 at [2, 1440, 1696, 128] (scan along W)."""
    variants = {k: v for k, v in PATH_VARIANTS.items()
                if knobs is None or k in knobs}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        paths = dict(zip(variants, ex.map(
            lambda d: cuda_agg.build(defines=d), variants.values())))
    libs = {k: cuda_agg.bind(ctypes.CDLL(v)) for k, v in paths.items()}
    L = cuda_agg.Launch
    g = torch.Generator(device="cuda").manual_seed(321)

    def vol(shape, dtype):
        c = torch.randint(0, 127, shape, generator=g, device="cuda",
                          dtype=torch.int32)
        i = torch.randint(0, 256, shape[:-1], generator=g, device="cuda",
                          dtype=torch.int32)
        return (c * 300 if dtype == torch.int32 else c.to(dtype)), i

    cases = {}
    for shape, shift in (((1, 1440, 1440, 128), 0), ((1, HW, HW, 256), 1),
                         ((1, HW, HW, 512), 1), ((1, HW, HW, 512), 0)):
        c, i = vol(shape, torch.int32)
        cases[f"row 5 {list(shape[1:])} shift {shift}"] = (
            "write", 2, (shift,), c, i, None)
    for hw, D in ((HW, 256), (HW, 512), (1440, 256)):
        c, i = vol((1, hw, hw, D), torch.int16)
        a = torch.randint(0, 500, c.shape, generator=g, device="cuda",
                          dtype=torch.int16)
        cases[f"diagonal add [{hw}, {hw}, {D}]"] = ("add", 1, (1,), c, i, a)
    c, i = vol((2, 1440, 1696, 128), torch.int16)
    a = torch.randint(0, 500, c.shape, generator=g, device="cuda",
                      dtype=torch.int16)
    cases["straight add [2, 1440, 1696, 128] scan W"] = (
        "add", 2, (0,), c, i, a)
    out = {}
    own = cuda_agg._library()
    for name, (mode, scan, shifts, c, i, a) in cases.items():
        plan = [L("path", scan, False, mode, shifts, "fused_pass", 0,
                  c.shape[0])]
        want = cuda_agg.plain_run_plan(plan, c, i, a, P1, P2)
        bound = c.numel() * c.element_size() * (3 if a is not None else 2)
        bound = (bound + 4 * i.numel()) / PEAK_BYTES_PER_S * 1e3
        runs = {}
        for k, lib in libs.items():
            def run(lib=lib):
                cuda_agg._lib = lib
                try:
                    return run_timed(plan, c, i, a)
                finally:
                    cuda_agg._lib = own
            runs[k] = run
        if parent is not None and mode == "write":
            pplan = [parent.Launch(*ln) for ln in plan]
            runs["parent"] = lambda: run_timed(pplan, c, i, None, parent)
        times = in_turns(runs, want, reps, name)
        out[name] = {"bound_ms": bound,
                     **{k: v["ms"] for k, v in times.items()}}
        print(f"probe {name}: bound {bound:.4f} ms; " + "; ".join(
            f"{k} {v['ms']:.3f}" for k, v in times.items()), flush=True)
    return out


# `sgm_deep_kernel` built with other knobs (the -D defines at the head of
# `csrc/sgm_agg.cu`): about how many warps walk a chain (so the depths a
# lane: `cuda_agg.deep_shape`), ring bytes a warp below 16 depths a lane
# and at 16, when a lane's result goes out through the ring stage (0
# never, 1 where its run is wider than 16 bytes, 2 also where it is not
# one aligned piece of 4, 8 or 16 bytes), how a warp fills its ring (0
# 16-byte pieces where its slice is aligned, else 4-byte words; 1 the
# 16-byte pieces that cover the slice; 2 the first for int32, the second
# for int16), and the step's barrier (0 __syncthreads, 1 a named barrier
# of the chain's threads); for --probe-deep. The first is the default
# build, the second the first design tried, each other one moves one knob
# from the default.
DEEP_KNOBS = [  # (warps, ring bytes, at 16 a lane, stage out, fill, barrier)
    (4, 8192, 4096, 1, 2, 0), (4, 4096, 4096, 1, 0, 0),
    (4, 8192, 4096, 1, 0, 0), (4, 8192, 4096, 1, 1, 0),
    (4, 4096, 4096, 1, 2, 0), (4, 8192, 8192, 1, 2, 0),
    (4, 8192, 4096, 2, 2, 0), (4, 8192, 4096, 0, 2, 0),
    (8, 8192, 4096, 1, 2, 0), (4, 8192, 4096, 1, 2, 1)]
DEEP_VARIANTS = {
    f"{w} warps, ring {b / 1024:g}/{b16 / 1024:g} KB, stage {st}, fill {fl}, "
    f"barrier {br}": (
        f"SGM_DEEP_WARPS={w}", f"SGM_DEEP_RING_BYTES={b}",
        f"SGM_DEEP_RING_BYTES_16={b16}", f"SGM_DEEP_STAGE_OUT={st}",
        f"SGM_DEEP_FILL={fl}", f"SGM_DEEP_BARRIER={br}")
    for w, b, b16, st, fl, br in DEEP_KNOBS}


def probe_deep(reps: int, parent, knobs=None) -> dict:
    """`sgm_deep_kernel` in every build of DEEP_VARIANTS named in
    ``knobs`` (all by default; and the parent checkout's, if given), in
    turns, each run bit-equal to plain, after each build's ptxas lines for
    the kernel: row 5 (int32, shift 1) at [640, 640, D] for D = 513, 1024
    and 2048, a diagonal adding into an int16 accumulator at [640, 640,
    1024], and `aggregate`'s per-path route (8 launches) at [640, 640,
    513]."""
    variants = {k: v for k, v in DEEP_VARIANTS.items()
                if knobs is None or k in knobs}
    reports = {k: [] for k in variants}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        paths = dict(zip(variants, ex.map(
            lambda k: cuda_agg.build(defines=variants[k],
                                     report=reports[k]), variants)))
    out = {"ptxas": {}}
    for k in variants:
        rows = [r for r in ptxas_summary("".join(reports[k]))
                if r.startswith("sgm_deep_kernel")]
        out["ptxas"][k] = rows
        print(f"{k}:\n  " + "\n  ".join(rows or ["(built before: no "
                                                   "report)"]), flush=True)
    libs = {k: cuda_agg.bind(ctypes.CDLL(v)) for k, v in paths.items()}
    L = cuda_agg.Launch
    g = torch.Generator(device="cuda").manual_seed(654)

    def vol(D, dtype):
        c = torch.randint(0, 127, (1, HW, HW, D), generator=g, device="cuda",
                          dtype=torch.int32)
        i = torch.randint(0, 256, (1, HW, HW), generator=g, device="cuda",
                          dtype=torch.int32)
        return (c * 300 if dtype == torch.int32 else c.to(dtype)), i

    cases = {}
    for D in (513, 1024, 2048):
        c, i = vol(D, torch.int32)
        cases[f"row 5 [640, 640, {D}] shift 1"] = (
            [L("deep", 2, False, "write", (1,), "scan_direction", 0, 1)], c,
            i, None)
    c, i = vol(1024, torch.int16)
    a = torch.randint(0, 500, c.shape, generator=g, device="cuda",
                      dtype=torch.int16)
    cases["diagonal add [640, 640, 1024]"] = (
        [L("deep", 1, False, "add", (1,), "fused_pass", 0, 1)], c, i, a)
    c, i = vol(513, torch.int16)
    plan = cuda_agg.per_path_plan(cuda_agg.plan_route(
        "aggregate", 1, HW, **cuda_agg.plan_geometry(c)), 513)
    cases["per-path aggregate [640, 640, 513]"] = (plan, c, i, None)
    own = cuda_agg._library()
    for name, (plan, c, i, a) in cases.items():
        want = cuda_agg.plain_run_plan(plan, c, i, a, P1, P2)
        runs = {}
        for k, lib in libs.items():
            def run(lib=lib, plan=plan, c=c, i=i, a=a):
                cuda_agg._lib = lib
                try:
                    return run_timed(plan, c, i, a)
                finally:
                    cuda_agg._lib = own
            runs[k] = run
        if parent is not None:
            pplan = [parent.Launch(*ln) for ln in plan]
            runs["parent"] = (lambda pplan=pplan, c=c, i=i, a=a:
                              run_timed(pplan, c, i, a, parent))
        times = in_turns(runs, want, reps, name)
        bound = cuda_agg.plan_bytes(plan, tuple(c.shape), c.element_size())
        out[name] = {"bound_ms": bound / PEAK_BYTES_PER_S * 1e3,
                     **{k: v["ms"] for k, v in times.items()}}
        print(f"probe {name}: bound {out[name]['bound_ms']:.4f} ms"
              + ("" if len(plan) == 1 else " (the plan's bytes)") + "; "
              + "; ".join(f"{k} {v['ms']:.3f}" for k, v in times.items()),
              flush=True)
        del want
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--depths", type=int, nargs="+", default=None,
                    help="D of the [640, 640, D] problems (default: 513 "
                    "1024 2048; with --row5 256 512 2048)")
    ap.add_argument("--probe", action="store_true",
                    help="time single 3-path launches in variants that "
                    "tell a step's parts apart, and nothing else")
    ap.add_argument("--root", default=None,
                    help="a second checkout whose one-path-per-launch "
                    "kernels are timed in turns with this tree's")
    ap.add_argument("--probe-path", action="store_true",
                    help="time single sgm_path_kernel launches built with "
                    "other ring sizes, warps and output paths")
    ap.add_argument("--probe-deep", action="store_true",
                    help="time single sgm_deep_kernel launches built with "
                    "other warps a chain, ring sizes, output paths and "
                    "barriers")
    ap.add_argument("--knobs", nargs="+", default=None,
                    help="with --probe-path or --probe-deep: the "
                    "PATH_VARIANTS or DEEP_VARIANTS to build (default: all)")
    ap.add_argument("--row5", action="store_true",
                    help="time Pallas row 5 (scan_direction) instead of "
                    "aggregate")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("deep_pace: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    parent = load_root(args.root) if args.root else None
    ptxas = build_report(cuda_agg)
    print("\n".join(ptxas), flush=True)
    res = {"card": card, "ptxas": ptxas, "depths": {}}
    if parent is not None:
        res["root"] = os.path.abspath(args.root)
        res["root_ptxas"] = build_report(parent)
        print("the parent checkout's:\n" + "\n".join(res["root_ptxas"]),
              flush=True)
    if args.probe:
        res["probe"] = {D: probe(D, args.reps)
                        for D in args.depths or [513, 1024, 2048]}
        print(json.dumps(res), flush=True)
        return 0
    if args.probe_path:
        res["probe_path"] = probe_path(args.reps, parent, args.knobs)
        print(json.dumps(res), flush=True)
        return 0
    if args.probe_deep:
        res["probe_deep"] = probe_deep(args.reps, parent, args.knobs)
        print(json.dumps(res), flush=True)
        return 0
    if args.row5:
        shapes = [((1440, 1440, 128), s) for s in (0, 1, -1)]
        shapes += [((HW, HW, D), 1) for D in args.depths or [256, 512, 2048]]
        res["row5"] = row5(shapes, args.reps, parent)
        print(json.dumps(res), flush=True)
        return 0
    for D in args.depths or [513, 1024, 2048]:
        cost, inten = seeded(D)
        geo = cuda_agg.plan_geometry(cost)
        new = cuda_agg.plan_route("aggregate", 1, HW, **geo)
        old = cuda_agg.per_path_plan(new, D)
        want = cuda_agg.plain_aggregate_batch(cost, inten, P1, P2).to(
            torch.int16)
        runs = {"new": lambda: run_timed(new, cost, inten),
                "old": lambda: run_timed(old, cost, inten)}
        if parent is not None:
            # The same per-path plan through the parent's kernels.
            root_old = [parent.Launch(*ln) for ln in old]
            runs["parent"] = lambda: run_timed(root_old, cost, inten, None,
                                                 parent)
        times = in_turns(runs, want, args.reps, f"D = {D}")
        shape = tuple(cost.shape)
        n = cost.numel()
        bound = (2 * n + 4 * (n // D) + 2 * n) / PEAK_BYTES_PER_S * 1e3
        row = {
            "shape": list(shape),
            "plan": [(ln.kernel, ln.scan, ln.reverse, ln.mode,
                      list(ln.shifts), ln.lines) for ln in new],
            "bound_ms": bound,
            "new_floor_ms": cuda_agg.plan_bytes(new, shape)
            / PEAK_BYTES_PER_S * 1e3,
            "old_floor_ms": cuda_agg.plan_bytes(old, shape)
            / PEAK_BYTES_PER_S * 1e3,
        }
        for k, v in times.items():
            row[f"{k}_ms"] = v["ms"]
            row[f"{k}_launch_ms"] = v["launch_ms"]
        res["depths"][D] = row
        print(f"D = {D}: "
              + "; ".join(f"{k} {v['ms']:.3f} ms ({len(v['launch_ms'])} "
                          "launches: " + ", ".join(
                              f"{t:.3f}" for t in v["launch_ms"]) + ")"
                          for k, v in times.items())
              + f"; floors {row['new_floor_ms']:.3f} / "
              f"{row['old_floor_ms']:.3f} ms, bound {bound:.4f} ms; "
              "bit-equal on every run", flush=True)
        del cost, inten, want
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
