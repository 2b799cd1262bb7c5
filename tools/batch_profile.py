"""Where the CLI's optimize stage spends its time, batched and not, on
the card.

Runs the `smvsrecon` CLI (`smvs_tpu_torch.cli`) on the scene of
`chip_smoke.py`'s view batching phase (8 views of `make_dtu_scene`'s
grid, 1440^2 and 1280^2 in turn; input scale 1, two buckets of 4), once
with its defaults to write the SGM checkpoints, then on the bucket of the
four 1440^2 views (`-l 0,2,4,6`) with `-r --force -d 1` at
`--batch-views 4` (one batched group) and at `--batch-views 1` (the same
SGM depths, read back from the checkpoints): first untraced, in turns
(4, 1, 1, 4, 4, 1), for the optimize stage's spread, then once each
under `torch.profiler`. Prints one JSON line with the untraced optimize
seconds, then one per traced run: the optimize stage's seconds (host clock,
traced, so slower than untraced), the device's busy seconds (the sum of
its kernels' times over the whole traced call) and its idle share of the
call's wall time, the kernel launches, the solver's host read-backs
(`utils.timing.host_reads`) and PCG passes by how they ran
(`utils.timing.pcg_passes`), the
optimizer's per-span seconds summed over groups (its `-d 1` report of
the program's spans: `opt.viewset`, `opt.visibility`, `opt.newton_step`,
`solver.pcg`, `opt.cleanup`, `opt.subdivide`, ... per scale)
and the ten ops with the most device time.

    python tools/batch_profile.py          # on a machine with the card
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smvs_tpu_torch import cli  # noqa: E402
from smvs_tpu_torch.core import synthetic as syn  # noqa: E402
from smvs_tpu_torch.device import set_cuda_precision  # noqa: E402
from smvs_tpu_torch.utils.timing import host_reads, pcg_passes  # noqa: E402

DIMS = (1440, 1280)
N_VIEWS = 8


def _stage_split(text: str) -> dict:
    """Sum the optimizer's `-d 1` stage reports over the groups."""
    out = defaultdict(float)
    for name, sec in re.findall(r"^\s+([\w.@]+)\s+([\d.]+)s  \(", text,
                                re.M):
        out[name] += float(sec)
    return {k: round(v, 3) for k, v in sorted(out.items())}


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _cli(path: str, batch_views: int, log: io.StringIO) -> None:
    with contextlib.redirect_stdout(log):
        rc = cli.main([path, "-r", "--force", "-d", "1", "-l", "0,2,4,6",
                       "--batch-views", str(batch_views)])
    if rc != 0:
        raise RuntimeError(f"the CLI exited with {rc}")


def _optimize_s(text: str) -> float:
    stages = re.search(r"Stage seconds: (.*)", text).group(1)
    return float(re.search(r"optimize ([\d.]+)", stages).group(1))


def untraced_runs(path: str, order=(4, 1, 1, 4, 4, 1)) -> dict:
    out = {4: [], 1: []}
    for n in order:
        log = io.StringIO()
        _cli(path, n, log)
        out[n].append(_optimize_s(log.getvalue()))
    return {"optimize_s_batch_4": out[4], "optimize_s_batch_1": out[1]}


def profiled_run(path: str, batch_views: int) -> dict:
    host_reads.clear()
    pcg_passes.clear()
    text = io.StringIO()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _cli(path, batch_views, text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = text.getvalue()
    stages = re.search(r"Stage seconds: (.*)", out).group(1)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    top = sorted(prof.key_averages(), key=lambda e: -_self_device_us(e))[:10]
    return {
        "batch_views": batch_views, "wall_s": round(wall, 3),
        "stages": stages, "optimize_s": _optimize_s(out),
        "device_busy_s": round(busy, 3),
        "idle_share": round(max(0.0, 1.0 - busy / wall), 4),
        "kernel_launches": len(kernels),
        "host_reads": dict(host_reads), "pcg_passes": dict(pcg_passes),
        "optimizer_stages_s": _stage_split(out),
        "groups": re.findall(r"Views \[.*", out),
        "top_device_ops": [(e.key, round(_self_device_us(e) / 1e6, 4),
                            e.count) for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("batch_profile: no CUDA device; this runs on the GPU")
    set_cuda_precision()
    dims = [DIMS[i % 2] for i in range(N_VIEWS)]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "dims": dims}),
          flush=True)
    scene = syn.make_dtu_scene(N_VIEWS, dims)
    with tempfile.TemporaryDirectory() as path:
        syn.save_as_mve_scene(scene, path)
        with contextlib.redirect_stdout(io.StringIO()):
            if cli.main([path, "-r"]) != 0:  # SGM checkpoints, warm-up
                raise RuntimeError("the first CLI run failed")
        print(json.dumps(untraced_runs(path)), flush=True)
        for n in (4, 1):
            print(json.dumps(profiled_run(path, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
