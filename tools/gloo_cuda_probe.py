"""Which gloo operations take CUDA tensors as they are, on ranks that share
one card.

Two gloo ranks on ``cuda:0`` (`smvs_tpu_torch.dist.launch.spawn`) try
all-reduce, broadcast, all-gather and a point-to-point exchange
(`batch_isend_irecv`) on CUDA tensors, each checked against the values it
must give, and build a ('views', 'patch') `DeviceMesh` for CUDA over the
gloo group. The point-to-point exchange runs in a spawn of its own, after
the others, since a transport handed a device pointer may take its
process down. Prints one JSON line: each operation's "ok", "wrong" or the
error.

    python tools/gloo_cuda_probe.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from smvs_tpu_torch.dist import launch  # noqa: E402
from smvs_tpu_torch.dist.mesh import make_mesh  # noqa: E402


def _try(fn) -> str:
    try:
        return "ok" if fn() else "wrong"
    except Exception as e:  # noqa: BLE001 - the probe records any failure
        return f"{type(e).__name__}: {e}"[:300]


def _collectives(rank: int, world: int, dev: torch.device) -> dict:
    def all_reduce():
        x = torch.full((5,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return x.is_cuda and bool((x == world * (world + 1) / 2).all())

    def broadcast():
        x = torch.full((5,), float(rank), device=dev)
        dist.broadcast(x, src=1)
        torch.cuda.synchronize()
        return bool((x == 1).all())

    def all_gather():
        x = torch.full((3,), float(rank), device=dev)
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x)
        torch.cuda.synchronize()
        return all(bool((o == r).all()) for r, o in enumerate(out))

    def device_mesh():
        mesh = make_mesh(world, patch_axis=world, device=dev)
        x = torch.ones(2, device=dev)
        dist.all_reduce(x, group=mesh.get_group("patch"))
        return bool((x == world).all())

    return {"all_reduce": _try(all_reduce), "broadcast": _try(broadcast),
            "all_gather": _try(all_gather), "device_mesh": _try(device_mesh)}


def _p2p(rank: int, world: int, dev: torch.device) -> dict:
    def exchange():
        peer = 1 - rank
        x = torch.full((4,), float(rank), device=dev)
        buf = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                       dist.P2POp(dist.irecv, buf, peer)])
        for r in reqs:
            r.wait()
        torch.cuda.synchronize()
        return bool((buf == peer).all())

    return {"send_recv": _try(exchange)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as d:
        res["rank_results"] = launch.spawn(
            _collectives, 2, backend="gloo", device="cuda",
            store_path=os.path.join(d, "a"), timeout=120)
        try:
            res["p2p"] = launch.spawn(_p2p, 2, backend="gloo", device="cuda",
                                      store_path=os.path.join(d, "b"),
                                      timeout=60)
        except (RuntimeError, TimeoutError) as e:
            res["p2p"] = f"the ranks failed: {e}"[:600]
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
