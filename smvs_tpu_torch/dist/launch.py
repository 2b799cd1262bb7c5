"""Starting the ranks of a multi-process run.

`spawn` runs a function on ``world_size`` processes started by
`torch.multiprocessing` with the ``spawn`` method (CUDA cannot be used in a
forked child). Each rank joins the default process group through a
`FileStore`, runs one intra-op thread, and places its tensors on one
device. The backend is the caller's choice and is never switched:

- ``"nccl"`` needs one card per rank (rank r on ``cuda:r``) and raises
  with fewer;
- ``"gloo"`` runs on the CPU, and for ranks that share a card (NCCL
  refuses two ranks on one device), where every rank's tensors stay on
  the card given (`dist.rows` says which exchanges then pass through host
  memory).

A rank's return value comes back to the caller through a file beside the
store; a rank that fails or a run that outlasts its timeout stops every
rank and raises.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from smvs_tpu_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")


def _result_path(store_path: str, rank: int) -> str:
    return f"{store_path}.rank{rank}"


def _rank_main(rank: int, fn, world_size: int, backend: str, device: str,
               store_path: str, timeout: float, args: tuple) -> None:
    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if backend == "nccl" else \
        torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dev = resolve_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout),
        device_id=dev if backend == "nccl" else None)
    try:
        out = fn(rank, world_size, dev, *args)
        torch.save(out, _result_path(store_path, rank))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *, backend: str, store_path: str,
          device: str | torch.device | None = None, args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size``
    spawned ranks; return their return values in rank order.

    ``fn`` is a module-level function (it is pickled by name) and returns
    something `torch.save` can write, its tensors on the CPU. ``device``
    is the card unless ``"cpu"`` is passed; with ``"gloo"`` every rank
    runs on it. ``store_path`` names a file that does not exist yet (the
    `FileStore`); the ranks' results are written beside it. Raises
    `RuntimeError` if a rank fails (the others are stopped) and
    `TimeoutError` if the run takes longer than ``timeout`` seconds.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if world_size < 1:
        raise ValueError(f"world_size {world_size} < 1")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA devices; use gloo on the CPU")
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(
                f"nccl needs one card per rank: {world_size} ranks, "
                f"{torch.cuda.device_count()} cards; ranks that share a "
                "card take gloo")
    if os.path.exists(store_path):
        raise ValueError(f"store file {store_path} exists; give a new path")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, backend, str(dev), store_path,
                          timeout, tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                    f"still running after {timeout} s")
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"a rank of {fn.__name__} failed:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"a rank of {fn.__name__} exited: {e}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(_result_path(store_path, r), weights_only=False)
            for r in range(world_size)]
