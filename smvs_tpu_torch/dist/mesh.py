"""The ('views', 'patch') device mesh and the placement of a view batch on
it (port of `make_mesh` and `batch_shardings` in
`smvs_tpu/dist/viewbatch.py`, and of `make_view_mesh` and `_shard_batch`
in `smvs_tpu/pipeline/batch.py`).

The mesh spans the ranks of the default process group, laid out row-major
as the JAX package reshapes `jax.devices()`: consecutive ranks share a
``views`` row, so a host's ranks split each view's node rows. Along
``views`` each rank takes a contiguous share of the views (data
parallelism); along ``patch`` a contiguous band of each view's node rows
(`dist.rows`, `dist.viewbatch`). Both are split as `torch.tensor_split`
splits, the first parts one longer. The JAX package replicates an axis
that does not divide; the port never replicates: an uneven split is
fine, and a band of no rows raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from smvs_tpu_torch.device import resolve_device

MESH_DIMS = ("views", "patch")
GATHER_ROWS = 8  # least rows of a rank's band of a coarse multigrid level


def make_mesh(n_devices: int | None = None, patch_axis: int = 1,
              device: str | torch.device | None = None) -> DeviceMesh:
    """The ('views', 'patch') mesh of shape (n // patch_axis, patch_axis)
    over the initialized default group's ``n`` ranks (``n_devices``, all
    of them by default), for tensors on ``device`` (the card unless
    ``"cpu"`` is passed)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "dist.launch.spawn or init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: start "
                         "as many ranks as the mesh has")
    if patch_axis < 1 or n % patch_axis:
        raise ValueError(f"{n} ranks do not split into rows of {patch_axis}")
    ranks = torch.arange(n).reshape(n // patch_axis, patch_axis)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=MESH_DIMS)


def split(n: int, parts: int, index: int) -> range:
    """Part ``index`` of ``range(n)`` cut into ``parts`` contiguous parts
    as `torch.tensor_split` cuts it."""
    size, extra = divmod(n, parts)
    lo = index * size + min(index, extra)
    return range(lo, lo + size + (index < extra))


def check_mesh(mesh: DeviceMesh) -> None:
    """Raise unless ``mesh`` is a DeviceMesh named ('views', 'patch')."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: a DeviceMesh, not {type(mesh).__name__}")
    if mesh.mesh_dim_names != MESH_DIMS:
        raise ValueError(f"mesh dims {mesh.mesh_dim_names}, not {MESH_DIMS}")


def view_share(V: int, mesh: DeviceMesh) -> range:
    """This rank's views of a batch of ``V`` (empty on a ``views`` row
    beyond the batch)."""
    check_mesh(mesh)
    return split(V, mesh.size(0), mesh.get_local_rank("views"))


def row_band(ny1: int, mesh: DeviceMesh) -> range:
    """This rank's node rows [r0, r1) of a grid of ``ny1`` rows."""
    check_mesh(mesh)
    n = mesh.size(1)
    if n > ny1:
        raise ValueError(f"{ny1} node rows cannot be split over {n} ranks "
                         "of the 'patch' axis: a band would be empty")
    return split(ny1, n, mesh.get_local_rank("patch"))


def coarse_band(band: range) -> range:
    """The next-coarser multigrid level's rows of a rank that holds the
    rows ``band`` of a level: the coarse rows I with 2I in ``band``
    (`solver.mg.coarse_size` keeps every even-index node). May be empty
    (a band of one odd row)."""
    return range((band.start + 1) // 2, (band.stop + 1) // 2)
