"""Demo: reconstruct depth for a synthetic two-view scene (port of
`examples/two_view_demo.py`).

Runs the pipeline end to end, SGM plane-sweep initialization (``--sgm``)
or a coarse fronto-parallel plane, then the coarse-to-fine Gauss-Newton
surface optimization, and reports accuracy against the analytic depth.
It exits 0 when the median relative depth error is below 1%.

Usage:  python -m smvs_tpu_torch.examples.two_view_demo [--device cpu] [--sgm]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from smvs_tpu_torch.core.synthetic import make_two_view_scene
from smvs_tpu_torch.device import device_name, resolve_device
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.pipeline.views import make_view
from smvs_tpu_torch.sgm import stereo as sgm
from smvs_tpu_torch.surface import state as S


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; \"cpu\" to run on "
                         "the CPU)")
    ap.add_argument("--sgm", action="store_true",
                    help="initialize from SGM instead of a coarse plane")
    ap.add_argument("--dim", type=int, default=232)
    ap.add_argument("--min-scale", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    name = device_name(dev)
    print(f"device: {name}")
    scene = make_two_view_scene(dim=args.dim, rotate=True,
                                texture="noise" if args.sgm else "checker")
    main_v = make_view(scene.cameras[1], scene.images[1], view_id=1,
                       device=dev)
    sub_v = make_view(scene.cameras[0], scene.images[0], view_id=0,
                      device=dev)
    gt = scene.depths[1]

    t0 = time.time()
    sgm_depth = None
    init_surface = None
    if args.sgm:
        sgm_depth = sgm.reconstruct_auto(
            scene.cameras[1], scene.cameras[0],
            torch.as_tensor(scene.images[1] * 255.0, device=dev),
            torch.as_tensor(scene.images[0] * 255.0, device=dev),
            range_main=(3.5, 9.0), range_nbr=(3.5, 9.0), device=dev)
        cov = float((sgm_depth > 0).float().mean())
        print(f"SGM done in {time.time()-t0:.1f}s, coverage {cov:.1%}")
    else:
        init_surface = S.create_planar(6.0, main_v.width, main_v.height, 5,
                                       device=dev)

    opts = O.OptimizerOptions(
        regularization=0.001,
        num_iterations=10 if not args.sgm else 5,
        min_scale=args.min_scale,
        use_sgm=args.sgm,
        full_optimization=True,
        max_newton_steps=50,
    )
    t0 = time.time()
    result = O.optimize_view(main_v, [sub_v], opts, sgm_depth=sgm_depth,
                             init_surface=init_surface, device=dev,
                             log=print)
    depth = result.depth.cpu().numpy()
    mask = depth > 0
    rel = np.abs(depth[mask] - gt[mask]) / gt[mask]
    print(f"optimization took {time.time()-t0:.1f}s")
    print(f"coverage:            {mask.mean():.1%}")
    print(f"median depth error:  {np.median(rel):.4%}")
    print(f"90th pct error:      {np.percentile(rel, 90):.4%}")
    return 0 if np.median(rel) < 0.01 else 1


if __name__ == "__main__":
    sys.exit(main())
