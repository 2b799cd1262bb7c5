"""The multi-rank dry run of the full batched pipeline (port of
`__graft_entry__.py:dryrun_multichip`).

Runs `pipeline.batch.optimize_view_batch` over a ('views', 'patch') mesh
of ``n`` spawned ranks on the plane scene at dim 96 with the JAX dry
run's options (`fixed_newton_steps`, so both paths run the same Newton
steps): as the JAX dry run, a ``patch`` axis of 2 when n is even (each
view's node rows split over two ranks), else 1, and n // patch views,
one per ``views`` row. Each view is held against the sequential
`optimizer.optimize_view` with the JAX dry run's bars: the same coverage,
rtol 1.5e-3 and atol 1e-6, and fewer than 10% of the pixels drifting by
more than 2e-4. The first rank of each ``views`` row checks the views
its row optimized; the caller then checks that every rank received
every view's depth map bit for bit.

    python -m smvs_tpu_torch.dist.dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.dist import launch
from smvs_tpu_torch.dist.mesh import view_share
from smvs_tpu_torch.dist.testing import plane_view_problem
from smvs_tpu_torch.pipeline import batch as VB
from smvs_tpu_torch.pipeline import optimizer as O


def patch_axis(n_ranks: int) -> int:
    """The JAX dry run's ``patch`` axis (`__graft_entry__.py:74`)."""
    return 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1


def check_bars(got: np.ndarray, want: np.ndarray, what: str) -> dict:
    """Hold a depth map to another with the JAX dry run's bars
    (`__graft_entry__.py:104-117`): the same coverage mask, rtol 1.5e-3
    and atol 1e-6, and fewer than 10% of the pixels drifting by more than
    2e-4 relative. Raises `AssertionError` naming ``what``; returns the
    largest absolute difference and the drifting share."""
    if not np.array_equal(got > 0, want > 0):
        raise AssertionError(f"{what}: {int(((got > 0) != (want > 0)).sum())}"
                             " pixels of another coverage")
    np.testing.assert_allclose(got, want, rtol=1.5e-3, atol=1e-6,
                               err_msg=what)
    drift = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    share = float((drift > 2e-4).mean())
    if not share < 0.10:
        raise AssertionError(f"{what}: {share:.3f} of the pixels drift by "
                             "more than 2e-4")
    return {"max_abs": float(np.abs(got - want).max()),
            "drift_share": share}


def _rank(rank: int, world: int, dev: torch.device) -> dict:
    p = patch_axis(world)
    mesh = VB.make_view_mesh(world, patch_axis=p, device=dev)
    mains, subs_list, inits = plane_view_problem(world // p, device=dev)
    opts = O.OptimizerOptions(regularization=0.01, num_iterations=2,
                              min_scale=4, use_sgm=False,
                              full_optimization=True, max_newton_steps=6,
                              fixed_newton_steps=True)
    out = VB.optimize_view_batch(mains, subs_list, opts, init_depths=inits,
                                 mesh=mesh, device=dev)
    for i in view_share(len(mains), mesh):
        if mesh.get_local_rank("patch") > 0:
            break  # the row's first rank checks its views
        ref = O.optimize_view(mains[i], subs_list[i], opts, device=dev,
                              init_depth=inits[i])
        check_bars(out[i].depth.cpu().numpy(), ref.depth.cpu().numpy(),
                   f"view {i}")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {"mesh": shape, "depths": [r.depth.cpu() for r in out]}


def dryrun_multichip(n_ranks: int, device=None, backend: str = "gloo"
                     ) -> None:
    """The dry run on ``n_ranks`` spawned ranks (gloo by default: the
    ranks may share one card); raises on any mismatch."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        outs = launch.spawn(_rank, n_ranks, backend=backend, device=dev,
                            store_path=os.path.join(d, "store"))
    for r, o in enumerate(outs[1:], 1):
        for i, (a, b) in enumerate(zip(outs[0]["depths"], o["depths"])):
            if not torch.equal(a, b):
                raise AssertionError(f"rank {r} received another depth map "
                                     f"of view {i} than rank 0")
    print(f"dryrun_multichip ok: mesh={outs[0]['mesh']} "
          f"views={len(outs[0]['depths'])} "
          f"depth={tuple(outs[0]['depths'][0].shape)} "
          "(full pipeline, sharded == sequential)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu for the CPU")
    ap.add_argument("--backend", choices=launch.BACKENDS, default="gloo")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
