"""Scaling harness of the view-batch path over spawned ranks (port of
`smvs_tpu/dist/scaling.py`).

`measure` times the sharded Newton step (`viewbatch.training_step_fn`;
view-steps per second, each step ending in every rank holding the new
nodes, `gather_nodes`), `measure_full_pipeline` the whole batched
coarse-to-fine pipeline (`pipeline.batch.optimize_view_batch` over the
mesh; views per second), both with a ``patch`` axis of 1 as the JAX
harness measures them, at each rank count against the first. The printout
says how many ranks share each card: ranks on one card (gloo) split its
time, so their "efficiency" measures that sharing, not scaling.

    python -m smvs_tpu_torch.dist.scaling [--ranks 1 2 4] \\
        [--views-per-rank 2] [--steps 5] [--full] [--backend gloo] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from smvs_tpu_torch.device import resolve_device, synchronize
from smvs_tpu_torch.dist import launch, viewbatch
from smvs_tpu_torch.dist.mesh import make_mesh
from smvs_tpu_torch.dist.testing import make_view_batch, plane_view_problem
from smvs_tpu_torch.pipeline import batch as VB
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.solver import gn

ARGS = ("nodes", "node_valid", "patch_valid", "vis", "active", "view")


def _step_rank(rank: int, world: int, dev: torch.device, views_per_rank: int,
               dim: int, steps: int) -> float:
    mesh = make_mesh(world, patch_axis=1, device=dev)
    template, batch = make_view_batch(world * views_per_rank, dim=dim,
                                      scale=4, device=dev)
    step = viewbatch.training_step_fn(template, gn.GNOptions(), mesh)
    args = [batch[k] for k in ARGS]
    viewbatch.gather_nodes(step(*args), mesh)  # warm-up
    synchronize(dev)
    t0 = time.perf_counter()
    nodes = args[0]
    for _ in range(steps):
        nodes = viewbatch.gather_nodes(step(nodes, *args[1:]), mesh)
    synchronize(dev)
    return time.perf_counter() - t0


def _pipeline_rank(rank: int, world: int, dev: torch.device,
                   views_per_rank: int, dim: int) -> float:
    mesh = VB.make_view_mesh(world, patch_axis=1, device=dev)
    mains, subs_list, inits = plane_view_problem(world * views_per_rank,
                                                 dim, device=dev)
    opts = O.OptimizerOptions(regularization=0.01, num_iterations=2,
                              min_scale=4, use_sgm=False,
                              full_optimization=True, max_newton_steps=6)

    def run():
        VB.optimize_view_batch(mains, subs_list, opts, init_depths=inits,
                               mesh=mesh, device=dev)
        synchronize(dev)

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _spawn(fn, n: int, backend: str, device, args: tuple) -> list:
    with tempfile.TemporaryDirectory() as d:
        return launch.spawn(fn, n, backend=backend, device=device,
                            store_path=os.path.join(d, "store"), args=args)


def measure(n_ranks: int, views_per_rank: int, dim: int = 116,
            steps: int = 5, *, backend: str, device=None) -> float:
    """View-steps per second of the sharded step on ``n_ranks`` ranks, a
    ('views', 1) mesh with ``views_per_rank`` views each."""
    secs = _spawn(_step_rank, n_ranks, backend, device,
                  (views_per_rank, dim, steps))
    return n_ranks * views_per_rank * steps / max(secs)


def measure_full_pipeline(n_ranks: int, views_per_rank: int, dim: int = 96,
                          *, backend: str, device=None) -> float:
    """Views per second of the batched pipeline on ``n_ranks`` ranks."""
    secs = _spawn(_pipeline_rank, n_ranks, backend, device,
                  (views_per_rank, dim))
    return n_ranks * views_per_rank / max(secs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--views-per-rank", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dim", type=int, default=None,
                    help="116 for the step, 96 for --full")
    ap.add_argument("--full", action="store_true",
                    help="measure the full batched pipeline, not one step")
    ap.add_argument("--backend", choices=launch.BACKENDS, default="gloo")
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"device {where}, backend {args.backend}")
    base = None  # throughput per rank at the first count
    for n in args.ranks:
        if args.full:
            thr = measure_full_pipeline(n, args.views_per_rank,
                                        args.dim or 96, backend=args.backend,
                                        device=dev)
            unit = "views/s"
        else:
            thr = measure(n, args.views_per_rank, args.dim or 116,
                          args.steps, backend=args.backend, device=dev)
            unit = "view-steps/s"
        base = thr / n if base is None else base
        share = (0 if dev.type != "cuda" else
                 1 if args.backend == "nccl" else n)  # ranks on each card
        print(f"  {n} ranks ({share} per card): {thr:8.2f} {unit} "
              f"(efficiency {thr / (base * n):.0%} against "
              f"{args.ranks[0]} ranks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
