"""DTU-scale scene benchmark: views per second of the `smvsrecon` CLI on
a 49-view scan of mixed sizes (port of the JAX repository's
`bench_dtu.py`).

`core.synthetic.make_dtu_scene` (a 7-column camera grid over the
analytic plane, about 70% of the views at ``SMVS_DTU_DIM`` and 30% at
``SMVS_DTU_DIM2``, so the CLI forms two shape buckets) is written as an
MVE scene to ``SMVS_DTU_DIR``, then reconstructed twice through
`cli.main` with ``-s SCALE -n 2 --min-neighbors 1 -o 2 -r -f`` (and
``-S`` under ``SMVS_DTU_SHADING=1``): a cold pass, the first in the
process, and a warm one. ``-r`` skips fusion, so both passes time the
views, SGM and optimize stages only. The SGM kernels are built before
the clock starts (the JAX driver's cold pass loaded its compiled
programs from a cache). Coverage and median relative error are the
cold pass's depth maps against the analytic depth.

A scene directory that already holds views is reused only when its view
count and image sizes are the ones asked for; otherwise this raises,
rather than measure another scene.

Prints ONE JSON line with the JAX driver's keys and ``device``; the
CLI's output and the progress go to stderr. Env: SMVS_DTU_VIEWS (49),
SMVS_DTU_DIM (1440), SMVS_DTU_DIM2 (1280), SMVS_DTU_SHADING (0),
SMVS_DTU_SCALE (0), SMVS_DTU_DIR (``dtu_scene`` in the temporary
directory). Runs on the GPU unless ``--device cpu``:

    python -m smvs_tpu_torch.bench_dtu [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from smvs_tpu_torch import cli
from smvs_tpu_torch.core import scene as sc
from smvs_tpu_torch.core.camera import depth_mve_to_z
from smvs_tpu_torch.core.synthetic import make_dtu_scene, save_as_mve_scene
from smvs_tpu_torch.device import device_name, resolve_device
from smvs_tpu_torch.sgm import cuda_agg


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def view_dims(n_views: int, dim1: int, dim2: int) -> list[int]:
    """Each view's size: views 7, 8, 9 of every ten at ``dim2``."""
    return [dim1 if (i % 10) < 7 else dim2 for i in range(n_views)]


def check_scene_dir(scene_dir: str, dims: list[int]) -> bool:
    """True when ``scene_dir`` holds a scene with one view of each size in
    ``dims`` (in order), False when it holds no views; raises ValueError
    for any other scene."""
    if not os.path.isdir(os.path.join(scene_dir, "views")):
        return False
    views = sc.Scene.load(scene_dir).views
    got = [tuple(np.asarray(v.get_image("undistorted")).shape[:2])
           for v in views]
    want = [(d, d) for d in dims]
    if got != want:
        raise ValueError(
            f"{scene_dir} holds another scene: {len(got)} views of sizes "
            f"{sorted(set(got))}, not {len(want)} of {sorted(set(want))}; "
            "give an empty or absent SMVS_DTU_DIR")
    return True


def measure_accuracy(scene_dir: str, scene, output_name: str):
    """(mean coverage, median of the views' median relative depth errors,
    megapixels, views) of the ``output_name`` depth maps."""
    covs, errs, mp = [], [], 0.0
    for v in sc.Scene.load(scene_dir).views:
        if not v.has_embedding(output_name):
            continue
        raw = np.asarray(v.get_image(output_name), np.float64)
        ic = v.camera.inverse_calibration(raw.shape[1], raw.shape[0])
        depth = depth_mve_to_z(raw, ic)
        gt = scene.depths[v.view_id]
        if depth.shape != gt.shape:  # working-scale output: pool the truth
            f = gt.shape[0] // depth.shape[0]
            gt = gt[::f, ::f][: depth.shape[0], : depth.shape[1]]
        mask = depth > 0
        mp += depth.size / 1e6
        covs.append(float(mask.mean()))
        if mask.any():
            rel = np.abs(depth[mask] - gt[mask]) / gt[mask]
            errs.append(float(np.median(rel)))
    return (float(np.mean(covs)) if covs else 0.0,
            float(np.median(errs)) if errs else -1.0, mp, len(covs))


def run(n_views: int = 49, dim1: int = 1440, dim2: int = 1280,
        shading: bool = False, in_scale: str = "0",
        scene_dir: str | None = None,
        device: str | torch.device | None = None) -> dict:
    """The benchmark's result dict (what `main` prints)."""
    dev = resolve_device(device)
    name = device_name(dev)
    if scene_dir is None:
        scene_dir = os.path.join(tempfile.gettempdir(), "dtu_scene")
    dims = view_dims(n_views, dim1, dim2)
    log(f"dtu bench: {n_views} views, dims {dim1}({dims.count(dim1)})/"
        f"{dim2}({dims.count(dim2)}), shading={shading}, device={name}")
    if dev.type == "cuda":
        cuda_agg.build()

    t0 = time.perf_counter()
    scene = make_dtu_scene(n_views, dims)
    if not check_scene_dir(scene_dir, dims):
        save_as_mve_scene(scene, scene_dir)
    log(f"scene generated+saved in {time.perf_counter() - t0:.1f}s -> "
        f"{scene_dir}")

    args = [scene_dir, "-s", in_scale, "-n", "2", "--min-neighbors", "1",
            "-o", "2", "-r", "-f", "--device", str(dev)]
    if shading:
        args.append("-S")
    # The CLI names its outputs by the input scale (`smvs-{B,S}<scale>`).
    output_name = ("smvs-S" if shading else "smvs-B") + in_scale

    def reconstruct(tag):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main(args)
        if rc != 0:
            raise RuntimeError(f"{tag} pass failed: cli.main returned {rc}")
        return time.perf_counter() - t0

    t_cold = reconstruct("cold")
    cov, err, mp, n_done = measure_accuracy(scene_dir, scene, output_name)
    log(f"cold: {t_cold:.1f}s, {n_done} views, cov {cov:.1%}, "
        f"err {err:.5f}")
    t_warm = reconstruct("warm")
    out = {
        "metric": "dtu_scene_throughput",
        "value": round(n_views / t_warm, 4),
        "unit": "views/s",
        "views": n_views,
        "dims": [dim1, dim2],
        "shading": shading,
        "input_scale": in_scale,
        "mp_total": round(mp, 1),
        "t_cold_s": round(t_cold, 1),
        "t_warm_s": round(t_warm, 1),
        "cold_over_warm": round(t_cold / t_warm, 2),
        "warm_mps": round(mp / t_warm, 4),
        "cold_views_per_s": round(n_views / t_cold, 4),
        "coverage": round(cov, 4),
        "median_rel_err": round(err, 6),
        "device": name,
    }
    log(f"warm: {t_warm:.1f}s -> {out['value']} views/s, "
        f"{out['warm_mps']} MP/s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; \"cpu\" to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    print(json.dumps(run(
        n_views=int(os.environ.get("SMVS_DTU_VIEWS", "49")),
        dim1=int(os.environ.get("SMVS_DTU_DIM", "1440")),
        dim2=int(os.environ.get("SMVS_DTU_DIM2", "1280")),
        shading=os.environ.get("SMVS_DTU_SHADING", "0") == "1",
        in_scale=os.environ.get("SMVS_DTU_SCALE", "0"),
        scene_dir=os.environ.get("SMVS_DTU_DIR"),
        device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
