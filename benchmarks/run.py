"""The benchmark of smvs_tpu_torch: depth-map throughput on one card.

    python3 benchmarks/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is a ``workloads`` entry of BENCHMARK.json (at the root of the
checkout). The run finds the cell's configuration file and traffic file by
the names there, renders the inputs on the card from ``--seed``, does what
the command line does once a run, warms up one request, then runs whole
requests in a closed loop (the next starts when the last has returned)
until ``--seconds`` have passed and the request in flight has completed.
After the window it checks the port's outputs against the plain reference
(`check`) and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each number compared with
its limit; also the last lines of standard error).

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics: each metric is a reader in ``metrics/<name>.py``; with
``--trace 1`` one more request runs under `torch.profiler` after the
window. Without a CUDA card, or with fewer than the cell asks for, the run
prints no result and exits 2; if a JAX module or the JAX package is loaded
when the window closes, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmarks")
# Top-level module names that no run may load: JAX and the JAX package
# (compared whole, so smvs_tpu_torch does not match smvs_tpu).
FORBIDDEN = ("jax", "jaxlib", "flax", "smvs_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names) -> list:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str, root: str = ROOT) -> tuple:
    """(cell, configuration, traffic) for a workload name, the
    configuration and traffic read from their files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmarks", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def metric_entries(bench: dict, trace: bool) -> list:
    """The metrics a run reports: end-to-end without the trace, per-layer
    with it (a reader that finds nothing to read leaves its metric out)."""
    return bench["per_layer"] if trace else bench["end_to_end"]


def load_reader(name: str, root: str = HERE):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics." + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Context:
    """What a metric reader reads: ``views`` and ``seconds`` of the
    window, its input megapixels ``mp``, ``setup_s``, ``peak_bytes``, the
    window's ``spans`` (seconds by name) and ``counters``, ``config``,
    and with the trace ``trace`` (`trace.Trace` of the traced request)
    and ``traced_sgm_pairs`` (the (height, width, planes) of each SGM pair
    the traced request aggregated)."""

    def __init__(self, **kw):
        self.trace = None
        self.traced_sgm_pairs = []
        self.__dict__.update(kw)


def run_cell(cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device, bench: dict,
             phases: dict, t_start: float) -> dict:
    """One run of a cell on ``device``: set-up, window, trace, check.
    Returns the result object (without printing it)."""
    import numpy as np
    import torch

    from benchmarks import check, drivers
    from smvs_tpu_torch.sgm import cuda_agg
    from smvs_tpu_torch.utils.timing import host_reads

    def phase(name, t0):
        phases[name] = time.perf_counter() - t0
        log(f"setup {name}: {phases[name]:.3f} s")

    if traffic["loop"] != "closed":
        raise SystemExit(f"loop {traffic['loop']!r}: the harness drives a "
                         "closed loop only")
    t0 = time.perf_counter()
    if device.type == "cuda":
        cuda_agg.build()
    phase("library", t0)
    drv = drivers.load(config["kind"])(config, traffic, seed, device)
    t0 = time.perf_counter()
    drv.render()
    phase("render", t0)
    t0 = time.perf_counter()
    drv.prepare()
    phase("prepare", t0)
    t0 = time.perf_counter()
    drv.run(drv.requests[0], drivers.Spans())
    drivers.synchronize(device)
    phase("warmup", t0)

    spans = drivers.Spans()
    host_reads.clear()
    cuda_agg.reset_launches()
    drv.sgm_pairs.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    outputs = []
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    k = 0
    def reads_now():
        return host_reads["cg"] + host_reads["newton"]

    def peak_now():
        return torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0

    while True:
        t1, reads = time.perf_counter(), reads_now()
        out = drv.run(drv.requests[k % len(drv.requests)], spans)
        log(f"request {k}: views {[o['view'] for o in out]} "
            f"{time.perf_counter() - t1:.3f} s, {reads_now() - reads} host "
            f"reads, peak {peak_now()} B")
        outputs += out
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    peak = peak_now()
    bad = forbidden_modules(sys.modules)
    if bad:
        log("loaded in the run: " + ", ".join(bad))
        raise SystemExit(3)
    counters = {"sgm_launches": sum(cuda_agg.launches.values()),
                "host_reads": host_reads["cg"] + host_reads["newton"]}
    ctx = Context(views=len(outputs), seconds=elapsed,
                  mp=sum(o["mp"] for o in outputs), setup_s=setup_s,
                  peak_bytes=peak, spans=spans.seconds, counters=counters,
                  config=config)
    log(f"window: {k} requests, {len(outputs)} views in {elapsed:.3f} s")
    if trace:
        from benchmarks import trace as tr

        drv.sgm_pairs.clear()
        _, ctx.trace = tr.capture(
            lambda: drv.run(drv.requests[0], drivers.Spans()))
        ctx.traced_sgm_pairs = list(drv.sgm_pairs)

    if device.type == "cuda":
        torch.cuda.empty_cache()  # the reference's room
    t0 = time.perf_counter()
    numbers = drv.check(outputs, np.random.default_rng(seed))
    correct, checks = check.verdict(numbers, config["limits"])
    log(f"check: {time.perf_counter() - t0:.3f} s")
    for name in check.NAMES:
        if name not in checks:
            log(f"reading {name}: {numbers[name]} (not compared)")
    bad = forbidden_modules(sys.modules)
    if bad:
        log("loaded in the run: " + ", ".join(bad))
        raise SystemExit(3)

    metrics = {}
    for entry in metric_entries(bench, trace):
        value = load_reader(entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(outputs),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        from benchmarks import trace as tr

        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": tr.top(ctx.trace.kernel_s),
                               "idle_gaps": ctx.trace.longest_gaps}
    result["checks"] = checks
    log(f"checked: {numbers['sgm_checked']} views against the reference, "
        f"{numbers['views_checked']} against the true depth")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    cell, config, traffic = find_cell(bench, args.workload)
    # Build and kernel caches stay inside the checkout, at fixed paths.
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    # Import the benchmark as the package it is, never its modules as
    # top-level ones from the script's directory.
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)

    # One process with one host thread for CPU tensor work: the port's host
    # side is a Python loop of launches, and idle OpenMP workers spinning
    # beside it only add jitter.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"the cell needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    from smvs_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    torch.ones(1, device=device).sum().item()  # the CUDA context
    from benchmarks import drivers

    drivers.load(config["kind"])  # the program's modules
    phases = {"import_cuda": time.perf_counter() - t0 + (t0 - T_START)}
    log(f"setup import_cuda: {phases['import_cuda']:.3f} s")
    log(f"card: {torch.cuda.get_device_name(device)}")
    result = run_cell(cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace), device, bench, phases, T_START)
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
