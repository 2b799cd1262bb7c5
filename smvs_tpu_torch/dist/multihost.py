"""Multi-process run of the sharded view-batch step (port of
`smvs_tpu/dist/multihost.py`).

PyTorch runs one rank per process: each worker joins the default process
group at a ``tcp://`` address, builds the ('views', 'patch') mesh over
all of them (views across processes, consecutive ranks on one ``views``
row), builds the synthetic view batch on its own, runs the sharded step
(`viewbatch.training_step_fn`) and checks its shard against a
single-process `viewbatch.batched_newton_step` on the same inputs, at the
JAX worker's float32 bar (rtol 2e-3, atol 5e-5). Start one worker per
process:

    python -m smvs_tpu_torch.dist.multihost --coordinator 127.0.0.1:PORT \\
        --num-processes 4 --process-id $I --backend gloo --device cpu

``--backend nccl`` (the default) takes one card per process
(``cuda:<process id % cards>``); ``gloo`` takes the CPU, or ranks that
share a card. Each worker prints ``MULTIHOST_OK process=<i> shards=<n>
mesh=<shape>``.
"""

from __future__ import annotations

import argparse
import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist

from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.dist import viewbatch
from smvs_tpu_torch.dist.mesh import make_mesh, row_band, view_share
from smvs_tpu_torch.dist.testing import make_view_batch
from smvs_tpu_torch.solver import gn

ARGS = ("nodes", "node_valid", "patch_valid", "vis", "active", "view")


def worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="HOST:PORT")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--patch-axis", type=int, default=2)
    ap.add_argument("--dim", type=int, default=116)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA devices; use gloo on the CPU")
        dev = torch.device("cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        args.backend, init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes, rank=args.process_id,
        timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(args.num_processes, patch_axis=args.patch_axis,
                         device=dev)
        n_views = mesh.size(0)
        template, batch = make_view_batch(n_views, dim=args.dim, scale=4,
                                          device=dev)
        inputs = [batch[k] for k in ARGS]
        gn_opts = gn.GNOptions()
        ref = viewbatch.batched_newton_step(template, gn_opts)(*inputs)
        shard = viewbatch.training_step_fn(template, gn_opts, mesh)(*inputs)
        share = view_share(n_views, mesh)
        band = row_band(template.nodes.shape[0], mesh)
        # The ranks of a band sum the PCG's dot products in another order
        # than one process does, and 200 float32 iterations amplify it.
        np.testing.assert_allclose(
            shard.cpu().numpy(),
            ref[share.start:share.stop, band.start:band.stop].cpu().numpy(),
            rtol=2e-3, atol=5e-5)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"MULTIHOST_OK process={args.process_id} shards=1 "
              f"mesh={shape}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
