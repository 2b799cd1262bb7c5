"""Scene-level benchmark: views per second of a plane scene through the
batched per-view pipeline (port of the JAX repository's
`bench_scene.py`).

``SMVS_SCENE_VIEWS`` views of `make_plane_scene` at ``SMVS_SCENE_DIM``:
each view's SGM against its two nearest views (averaged, each view
synchronized), then `pipeline.batch.optimize_view_batch` over groups of
``SMVS_SCENE_BATCH`` views (each group synchronized), then a second,
warm optimize pass over the same groups. The SGM kernels are built
before the clock starts: the JAX driver's cold pass loaded its compiled
programs from a cache, it compiled nothing, and the JAX `prewarm_async`
has no counterpart (`pipeline/batch.py`).

Prints ONE JSON line with the JAX driver's keys and ``device``; logs to
stderr. Env: SMVS_SCENE_DIM (720), SMVS_SCENE_VIEWS (10),
SMVS_SCENE_BATCH (5), SMVS_SCENE_MIN_SCALE (2). Runs on the GPU unless
``--device cpu``:

    python -m smvs_tpu_torch.bench_scene [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from smvs_tpu_torch.core.synthetic import make_plane_scene
from smvs_tpu_torch.device import device_name, resolve_device, synchronize
from smvs_tpu_torch.pipeline import batch as VB
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.pipeline.views import make_view
from smvs_tpu_torch.sgm import cuda_agg
from smvs_tpu_torch.sgm import stereo as sgm


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(dim: int = 720, n_views: int = 10, group: int = 5,
        min_scale: int = 2, device: str | torch.device | None = None
        ) -> dict:
    """The benchmark's result dict (what `main` prints)."""
    dev = resolve_device(device)
    name = device_name(dev)
    log(f"scene bench: device={name} dim={dim} views={n_views} "
        f"group={group} min_scale={min_scale}")
    if dev.type == "cuda":
        cuda_agg.build()

    scene = make_plane_scene(n_views=n_views, dim=dim)
    views = [make_view(scene.cameras[i], scene.images[i], view_id=i,
                       device=dev) for i in range(n_views)]
    synchronize(dev)

    def neighbors(i):
        return sorted((j for j in range(n_views) if j != i),
                      key=lambda j: abs(j - i))[:2]

    opts = O.OptimizerOptions(regularization=0.01, num_iterations=5,
                              min_scale=min_scale, use_sgm=True)
    groups = [list(range(g0, min(g0 + group, n_views)))
              for g0 in range(0, n_views, group)]

    def optimize(sgm_depths):
        results = []
        for idx in groups:
            results += VB.optimize_view_batch(
                [views[i] for i in idx],
                [[views[j] for j in neighbors(i)] for i in idx], opts,
                sgm_depths=[sgm_depths[i] for i in idx], device=dev)
            synchronize(dev)
        return results

    t_start = time.perf_counter()
    sgm_depths = []
    for i in range(n_views):
        nbrs = neighbors(i)
        sgm_depths.append(sgm.reconstruct_auto_multi(
            scene.cameras[i], [scene.cameras[j] for j in nbrs],
            views[i].image * 255.0, [views[j].image * 255.0 for j in nbrs],
            (3.4, 6.6), [(3.4, 6.6)] * len(nbrs), device=dev))
        synchronize(dev)
    t_sgm = time.perf_counter() - t_start
    log(f"sgm init: {t_sgm:.2f}s ({n_views} views x 2 neighbors)")

    t0 = time.perf_counter()
    results = optimize(sgm_depths)
    t_opt = time.perf_counter() - t0
    total = time.perf_counter() - t_start

    t0 = time.perf_counter()
    optimize(sgm_depths)
    t_warm_opt = time.perf_counter() - t0
    log(f"warm optimize pass: {t_warm_opt:.2f}s "
        f"({n_views / t_warm_opt:.2f} views/s)")

    covs, errs = [], []
    for i, res in enumerate(results):
        depth = res.depth.cpu().numpy()
        mask = depth > 0
        gt = scene.depths[i]
        covs.append(float(mask.mean()))
        errs.append(float(np.median(
            np.abs(depth[mask] - gt[mask]) / gt[mask])))
    cov = float(np.mean(covs))
    err = float(np.median(errs))
    out = {
        "metric": "scene_throughput",
        "value": round(n_views / total, 4),
        "unit": "views/s",
        "mps": round(n_views * dim * dim / 1e6 / total, 4),
        "dim": dim, "views": n_views, "group": group,
        "t_sgm_s": round(t_sgm, 2), "t_opt_s": round(t_opt, 2),
        "t_total_s": round(total, 2),
        "t_warm_opt_s": round(t_warm_opt, 2),
        "warm_views_per_s": round(n_views / t_warm_opt, 4),
        "coverage": round(cov, 4), "median_rel_err": round(err, 6),
        "device": name,
    }
    log(f"scene: {total:.1f}s total -> {out['value']} views/s, "
        f"{out['mps']} MP/s, coverage {cov:.1%}, err {err:.5f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; \"cpu\" to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    print(json.dumps(run(
        dim=int(os.environ.get("SMVS_SCENE_DIM", "720")),
        n_views=int(os.environ.get("SMVS_SCENE_VIEWS", "10")),
        group=int(os.environ.get("SMVS_SCENE_BATCH", "5")),
        min_scale=int(os.environ.get("SMVS_SCENE_MIN_SCALE", "2")),
        device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
