"""The port's benchmark paths: one ~2 MP view, base mode and shading-aware.

`run_once` mirrors `bench.py:run_once` of the JAX package: the synthetic
two-view scene with a resolution-independent slanted plane, rectified SGM,
then the coarse-to-fine optimizer from the SGM depth. `run_shading_once`
mirrors `bench.py:run_shading_once`, the flagship: the 3-view plane scene,
the SGM of both neighbors averaged, then the shading-aware (`-S`)
optimizer against both. Each returns ``(t_sgm, t_opt, coverage,
median_rel_err)``, the times in seconds on the host clock around work
that ends in a device synchronize.

Run it directly for one warm-up and one timed pass on the GPU:

    python -m smvs_tpu_torch.bench_main --dim 1440 --min-scale 2
    python -m smvs_tpu_torch.bench_main --dim 1440 --shading

``--profile DIR`` adds one pass under `torch.profiler` and writes its
table of device time by operation to ``DIR/profile_<dim>.txt``; and one
pass with the optimizer's stages synchronized, for their times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from smvs_tpu_torch.core.synthetic import (make_plane_scene,
                                           make_two_view_scene)
from smvs_tpu_torch.device import device_name, resolve_device, synchronize
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.pipeline.views import make_view
from smvs_tpu_torch.sgm import stereo as sgm

# The program's spans of the two stages (`utils.timing`), read by
# `profile`, with the names of its keys.
SPANS = {"sgm.pair": "sgm", "opt.view": "optimizer"}


def run_once(dim: int, min_scale: int,
             device: str | torch.device | None = None, verbose: bool = False,
             sync_stages: bool = False, details: dict | None = None):
    """One reconstruction -> (t_sgm, t_opt, coverage, median_rel_err).

    ``verbose`` logs the optimizer's progress and stage times to stderr;
    ``sync_stages`` makes those stage times exact by synchronizing the
    device at each stage boundary (which costs the overlap); ``details``
    (a dict), if given, receives the views ("main", "subs"), the SGM
    depth ("sgm_depth"), the optimizer's options ("opts"), its
    `DepthResult` ("result") and the analytic depth ("gt").
    """
    dev = resolve_device(device)
    log = (lambda m: print(m, file=sys.stderr, flush=True)) if verbose \
        else None
    slope = 0.005 * 460.0 / dim
    scene = make_two_view_scene(
        dim=dim, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    main_v = make_view(scene.cameras[1], scene.images[1], view_id=1,
                       device=dev)
    sub_v = make_view(scene.cameras[0], scene.images[0], view_id=0,
                      device=dev)
    synchronize(dev)  # images resident before the clock starts

    t0 = time.perf_counter()
    sgm_depth = sgm.reconstruct_auto(
        scene.cameras[1], scene.cameras[0], main_v.image * 255.0,
        sub_v.image * 255.0, range_main=(3.5, 9.5), range_nbr=(3.5, 9.5),
        device=dev)
    synchronize(dev)
    t_sgm = time.perf_counter() - t0

    t0 = time.perf_counter()
    opts = O.OptimizerOptions(regularization=0.01, num_iterations=5,
                              min_scale=min_scale, use_sgm=True,
                              debug_lvl=2 if sync_stages else 0)
    result = O.optimize_view(main_v, [sub_v], opts, sgm_depth=sgm_depth,
                             device=dev, log=log)
    synchronize(dev)
    t_opt = time.perf_counter() - t0
    if details is not None:
        details.update(main=main_v, subs=[sub_v], sgm_depth=sgm_depth,
                       opts=opts, result=result, gt=scene.depths[1])

    depth = result.depth.cpu().numpy()
    mask = depth > 0
    gt = scene.depths[1]
    rel = np.abs(depth[mask] - gt[mask]) / gt[mask]
    return t_sgm, t_opt, float(mask.mean()), float(np.median(rel))


def run_shading_once(dim: int, min_scale: int,
                     device: str | torch.device | None = None,
                     verbose: bool = False, sync_stages: bool = False,
                     log=None, details: dict | None = None):
    """The flagship, shading-aware (`-S`) with 2 neighbors on the 3-view
    plane scene -> (t_sgm, t_opt, coverage, median_rel_err), with the
    options of `bench.py:run_shading_once`. ``verbose`` and
    ``sync_stages`` as for `run_once`; ``log`` (a callable) receives the
    optimizer's progress lines and stage report instead of stderr;
    ``details`` (a dict), if given, receives the optimizer's `DepthResult`
    ("result"), the views ("main", "subs") and its options ("opts").
    """
    dev = resolve_device(device)
    if log is None and verbose:
        log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    scene = make_plane_scene(n_views=3, dim=dim)
    views = [make_view(scene.cameras[i], scene.images[i], view_id=i,
                       device=dev) for i in range(3)]
    main_v = views[1]
    subs = [views[0], views[2]]
    synchronize(dev)  # images resident before the clock starts

    t0 = time.perf_counter()
    sgm_depth = sgm.reconstruct_auto_multi(
        scene.cameras[1], [scene.cameras[s.view_id] for s in subs],
        main_v.image * 255.0, [s.image * 255.0 for s in subs],
        (3.4, 6.6), [(3.4, 6.6)] * len(subs), device=dev)
    synchronize(dev)
    t_sgm = time.perf_counter() - t0

    t0 = time.perf_counter()
    opts = O.OptimizerOptions(
        regularization=0.01, light_surf_regularization=0.0,
        num_iterations=5, min_scale=min_scale, use_sgm=True,
        use_shading=True, debug_lvl=2 if sync_stages else 0)
    result = O.optimize_view(main_v, subs, opts, sgm_depth=sgm_depth,
                             device=dev, log=log)
    synchronize(dev)
    t_opt = time.perf_counter() - t0
    if details is not None:
        details.update(result=result, main=main_v, subs=subs, opts=opts)

    depth = result.depth.cpu().numpy()
    mask = depth > 0
    gt = scene.depths[1]
    rel = np.abs(depth[mask] - gt[mask]) / gt[mask]
    return t_sgm, t_opt, float(mask.mean()), float(np.median(rel))


def _busy_us(spans, lo: float, hi: float) -> float:
    """Length of the union of [start, end) spans clipped to [lo, hi)."""
    busy, reach = 0.0, lo
    for start, end in spans:  # sorted by start
        start, end = max(start, reach), min(end, hi)
        if end > start:
            busy += end - start
            reach = end
    return busy


def profile(dim: int, min_scale: int, device: torch.device, out_dir: str
            ) -> dict:
    """One `run_once` under `torch.profiler` (after a warm-up run).

    Writes the table of device time by operation to
    ``out_dir/profile_<dim>.txt`` and returns, for the SGM and the
    optimizer span, the seconds the device was busy (kernels and copies)
    and its idle share of the span (the program's spans `SPANS`, which a
    running profiler turns on). The profiler slows the host side, so
    the spans are longer and the idle shares higher than untraced.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    if device.type != "cuda":
        raise ValueError("the profile measures the GPU; it needs a CUDA "
                         "device")
    run_once(dim, min_scale, device)
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        run_once(dim, min_scale, device)
    events = prof.events()
    # Device work: kernels and copies. Left out are the device-side copies
    # of the host annotations (the program's spans) and "Command Buffer
    # Full" (the host waiting for a free launch slot).
    annotations = {e.name for e in events if e.device_type == DeviceType.CPU
                   and getattr(e, "is_user_annotation", False)}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in annotations | {"Command Buffer Full"}]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    out = {}
    for e in events:
        if e.name in SPANS and e.device_type == DeviceType.CPU:
            lo, hi = e.time_range.start, e.time_range.end
            busy = _busy_us(spans, lo, hi)
            key = SPANS[e.name]
            out[f"{key}_traced_s"] = (hi - lo) / 1e6
            out[f"{key}_device_busy_s"] = busy / 1e6
            out[f"{key}_idle_share"] = 1.0 - busy / (hi - lo)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{dim}.txt")
    with open(path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60,
            max_name_column_width=60))
    out["profile_table"] = path
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=1440)
    ap.add_argument("--min-scale", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--shading", action="store_true",
                    help="the shading-aware flagship (run_shading_once)")
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.shading and args.profile:
        ap.error("--profile traces run_once only")
    run = run_shading_once if args.shading else run_once
    run(args.dim, args.min_scale, dev)  # warm-up
    t_sgm, t_opt, cov, err = run(args.dim, args.min_scale, dev,
                                 verbose=True)
    out = {"device": device_name(dev), "path": run.__name__, "dim": args.dim,
           "t_sgm": t_sgm, "t_opt": t_opt,
           "mps": args.dim * args.dim / 1e6 / (t_sgm + t_opt),
           "coverage": cov, "median_rel_err": err}
    if args.profile:
        out.update(profile(args.dim, args.min_scale, dev, args.profile))
        run_once(args.dim, args.min_scale, dev, verbose=True,
                 sync_stages=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
