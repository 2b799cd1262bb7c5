"""Masked dense surface state — the optimized variable of the depth solver
(port of `smvs_tpu/surface/state.py`, reference `lib/surface.h/.cc`).

The surface is a dense node grid plus validity masks; topology operations
are masked tensor ops. Grid geometry (reference `lib/surface.cc:19-53`):
``patchsize = 2**scale`` pixels per patch edge; patch (i, j) covers pixels
``[start_x + i*ps, start_x + (i+1)*ps) x [start_y + j*ps, ...)``; node
(i, j) sits at pixel ``(start_x + i*ps, start_y + j*ps)`` and carries
(f, dx, dy, dxy) in patch-normalized units.

A batch of views of one shape is a Surface whose tensors carry a leading
view axis (`stack_surfaces`; nodes [V, ny+1, nx+1, 4]). The Newton step's
operations (`patch_params`, `update_nodes`) take it directly; the
once-per-scale and cleanup operations marked ``@over_views`` run view by
view on it, so each view's result equals the one it gets alone.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from smvs_tpu_torch.geometry import normals as nrm
from smvs_tpu_torch.surface import bicubic


@dataclasses.dataclass
class Surface:
    nodes: torch.Tensor  # [(V,) ny+1, nx+1, 4] (f, dx, dy, dxy)
    node_valid: torch.Tensor  # bool [(V,) ny+1, nx+1]
    patch_valid: torch.Tensor  # bool [(V,) ny, nx]
    scale: int
    width: int
    height: int
    start_x: int
    start_y: int

    @property
    def patchsize(self) -> int:
        return 1 << self.scale

    @property
    def num_patches_x(self) -> int:
        return self.patch_valid.shape[-1]

    @property
    def num_patches_y(self) -> int:
        return self.patch_valid.shape[-2]

    @property
    def batched(self) -> bool:
        return self.nodes.ndim == 4

    def num_valid_patches(self) -> int:
        return int(self.patch_valid.sum())

    def num_valid_nodes(self) -> int:
        return int(self.node_valid.sum())


def stack_surfaces(surfs: list[Surface]) -> Surface:
    """Batch surfaces of one grid on a leading view axis (the grid meta
    of the first)."""
    return dataclasses.replace(
        surfs[0],
        nodes=torch.stack([s.nodes for s in surfs]),
        node_valid=torch.stack([s.node_valid for s in surfs]),
        patch_valid=torch.stack([s.patch_valid for s in surfs]))


def unstack_surface(bsurf: Surface, i: int) -> Surface:
    """View ``i`` of a batched surface."""
    return dataclasses.replace(bsurf, nodes=bsurf.nodes[i],
                               node_valid=bsurf.node_valid[i],
                               patch_valid=bsurf.patch_valid[i])


def over_views(fn):
    """Let a per-view surface operation take a batched surface: view i
    runs alone with the i-th entry of each further argument, and the
    results (surfaces or tensors) are stacked again."""

    @functools.wraps(fn)
    def run(surf: Surface, *args):
        if not surf.batched:
            return fn(surf, *args)
        outs = [fn(unstack_surface(surf, i), *(a[i] for a in args))
                for i in range(surf.nodes.shape[0])]
        if isinstance(outs[0], Surface):
            return stack_surfaces(outs)
        return torch.stack(outs)

    return run


def _pad2(x: torch.Tensor, top: int, bottom: int, left: int, right: int
          ) -> torch.Tensor:
    """Zero (False) pad of the two leading dims of ``x``."""
    ny, nx = x.shape[:2]
    out = torch.zeros((ny + top + bottom, nx + left + right, *x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    out[top:top + ny, left:left + nx] = x
    return out


# ---------------------------------------------------------------------------
# construction


def _grid_dims(width: int, height: int, scale: int, planar: bool = False
               ) -> tuple[int, int, int, int]:
    """Patch grid of the reference constructor (`lib/surface.cc:29-30`),
    or with ``planar`` of `Surface::initialize_planar` (:63-64)."""
    ps = 1 << scale
    nx = (width - 2) // ps - (0 if planar else 1)
    ny = (height - 2) // ps - (0 if planar else 1)
    sx = (width - nx * ps) // 2
    sy = (height - ny * ps) // 2
    return nx, ny, sx, sy


def create_planar(depth: float, width: int, height: int, scale: int,
                  dtype=torch.float32, device=None) -> Surface:
    """Fully valid fronto-parallel surface at z-depth ``depth``
    (reference `Surface::initialize_planar`)."""
    nx, ny, sx, sy = _grid_dims(width, height, scale, planar=True)
    nodes = torch.zeros((ny + 1, nx + 1, 4), dtype=dtype, device=device)
    nodes[..., 0] = depth
    return Surface(
        nodes=nodes,
        node_valid=torch.ones((ny + 1, nx + 1), dtype=torch.bool,
                              device=device),
        patch_valid=torch.ones((ny, nx), dtype=torch.bool, device=device),
        scale=scale, width=width, height=height, start_x=sx, start_y=sy,
    )


def create_from_depth(depth: torch.Tensor, scale: int) -> Surface:
    """Surface initialized from a (sparse or dense) z-depth map
    (reference `Surface::Surface` + `fill_patches_from_depth`,
    `lib/surface.cc:19-53, 140-152`)."""
    height, width = depth.shape
    nx, ny, sx, sy = _grid_dims(width, height, scale)
    dev = depth.device
    surf = Surface(
        nodes=torch.zeros((ny + 1, nx + 1, 4), dtype=depth.dtype, device=dev),
        node_valid=torch.zeros((ny + 1, nx + 1), dtype=torch.bool, device=dev),
        patch_valid=torch.zeros((ny, nx), dtype=torch.bool, device=dev),
        scale=scale, width=width, height=height, start_x=sx, start_y=sy,
    )
    return fill_patches_from_depth(surf, depth)


# ---------------------------------------------------------------------------
# node initialization from a depth map


def _node_windows(surf: Surface, depth: torch.Tensor) -> torch.Tensor:
    """The ps x ps window centered on each node: [ny+1, nx+1, ps, ps];
    out-of-image samples are 0 (holes)."""
    ps = surf.patchsize
    ws = ps // 2
    ny1 = surf.num_patches_y + 1
    nx1 = surf.num_patches_x + 1
    y0 = surf.start_y - ws
    x0 = surf.start_x - ws
    pad_top = max(0, -y0)
    pad_left = max(0, -x0)
    pad_bottom = max(0, y0 + ny1 * ps - depth.shape[0])
    pad_right = max(0, x0 + nx1 * ps - depth.shape[1])
    dp = torch.nn.functional.pad(depth, (pad_left, pad_right, pad_top,
                                         pad_bottom))
    block = dp[y0 + pad_top : y0 + pad_top + ny1 * ps,
               x0 + pad_left : x0 + pad_left + nx1 * ps]
    return block.reshape(ny1, ps, nx1, ps).permute(0, 2, 1, 3)


def initialize_nodes_from_depth(surf: Surface, depth: torch.Tensor
                                ) -> Surface:
    """Fill currently-invalid nodes from depth statistics: f = median of
    the positive samples of the node's window, derivatives from the
    quadrant minima (reference `lib/surface.cc:667-760`, including its
    partial-quadrant fallback rules)."""
    ps = surf.patchsize
    ws = ps // 2
    win = _node_windows(surf, depth)  # [ny1, nx1, ps, ps] rows=y, cols=x
    pos = win > 0
    ny1, nx1 = win.shape[:2]

    q = win.reshape(ny1, nx1, 2, ws, 2, ws)
    qpos = pos.reshape(ny1, nx1, 2, ws, 2, ws)
    big = torch.inf
    qmin = torch.where(qpos, q, big).amin(dim=(3, 5))  # [ny1, nx1, 2, 2]
    qcnt = qpos.sum(dim=(3, 5))
    m0 = torch.where(qcnt[..., 0, 0] > 0, qmin[..., 0, 0], 0.0)
    m1 = torch.where(qcnt[..., 0, 1] > 0, qmin[..., 0, 1], 0.0)
    m2 = torch.where(qcnt[..., 1, 0] > 0, qmin[..., 1, 0], 0.0)
    m3 = torch.where(qcnt[..., 1, 1] > 0, qmin[..., 1, 1], 0.0)
    nonzero_quadrants = sum((m > 0).to(torch.int32) for m in (m0, m1, m2, m3))

    total = pos.sum(dim=(2, 3))
    flat = torch.where(pos, win, big).reshape(ny1, nx1, ps * ps)
    svals = torch.sort(flat, dim=-1).values
    med_idx = torch.clamp(total // 2, 0, ps * ps - 1)
    f = torch.gather(svals, -1, med_idx[..., None])[..., 0]

    all4 = nonzero_quadrants == 4
    dx_full = ((m1 + m3) - (m0 + m2)) / 2.0
    dy_full = ((m2 + m3) - (m0 + m1)) / 2.0
    dxy_full = (m3 - m2) - (m1 - m0)
    dx_c1 = ((m1 == 0) | (m0 == 0)) & (m3 != 0) & (m2 != 0)
    dx_c2 = ((m2 == 0) | (m3 == 0)) & (m1 != 0) & (m0 != 0)
    dx_part = torch.where(dx_c1, m3 - m2, torch.where(dx_c2, m1 - m0, 0.0))
    dy_c1 = ((m0 == 0) | (m2 == 0)) & (m3 != 0) & (m1 != 0)
    dy_c2 = ((m1 == 0) | (m2 == 0)) & (m0 != 0) & (m2 != 0)
    dy_part = torch.where(dy_c1, m3 - m1, torch.where(dy_c2, m2 - m0, 0.0))

    dx = torch.where(all4, dx_full, dx_part)
    dy = torch.where(all4, dy_full, dy_part)
    dxy = torch.where(all4, dxy_full, 0.0)

    makeable = (total >= 2) & (nonzero_quadrants > 0)
    fill = makeable & ~surf.node_valid
    new_vals = torch.stack([f, dx, dy, dxy], dim=-1)
    nodes = torch.where(fill[..., None], new_vals, surf.nodes)
    node_valid = surf.node_valid | fill
    return dataclasses.replace(surf, nodes=nodes, node_valid=node_valid)


@over_views
def fill_patches_from_depth(surf: Surface, depth: torch.Tensor) -> Surface:
    """Initialize nodes, fill holes, clean up (reference :140-152)."""
    surf = initialize_nodes_from_depth(surf, depth)
    surf = fill_holes(surf)
    return remove_nodes_without_patch(surf)


# ---------------------------------------------------------------------------
# topology ops (all pure mask updates)


def fill_holes(surf: Surface) -> Surface:
    """Create every patch whose 4 corner nodes exist (reference :630-651)."""
    nv = surf.node_valid
    all4 = nv[:-1, :-1] & nv[:-1, 1:] & nv[1:, :-1] & nv[1:, 1:]
    return dataclasses.replace(surf, patch_valid=surf.patch_valid | all4)


def remove_nodes_without_patch(surf: Surface) -> Surface:
    """Drop nodes not adjacent to any valid patch (reference :762-869)."""
    pv = _pad2(surf.patch_valid, 1, 1, 1, 1)
    adjacent = pv[:-1, :-1] | pv[:-1, 1:] | pv[1:, :-1] | pv[1:, 1:]
    node_valid = surf.node_valid & adjacent
    nodes = torch.where(node_valid[..., None], surf.nodes, 0.0)
    return dataclasses.replace(surf, nodes=nodes, node_valid=node_valid)


def remove_patches_without_nodes(surf: Surface) -> Surface:
    """Drop patches whose 4 corner nodes are not all valid."""
    nv = surf.node_valid
    all4 = nv[:-1, :-1] & nv[:-1, 1:] & nv[1:, :-1] & nv[1:, 1:]
    return dataclasses.replace(surf, patch_valid=surf.patch_valid & all4)


@over_views
def remove_isolated_patches(surf: Surface) -> Surface:
    """Delete patches with < 3 of 8 valid neighbors (reference :888-927)."""
    pv = _pad2(surf.patch_valid.to(torch.int32), 1, 1, 1, 1)
    neigh = (
        pv[:-2, :-2] + pv[:-2, 1:-1] + pv[:-2, 2:]
        + pv[1:-1, :-2] + pv[1:-1, 2:]
        + pv[2:, :-2] + pv[2:, 1:-1] + pv[2:, 2:]
    )
    keep = surf.patch_valid & (neigh >= 3)
    return remove_nodes_without_patch(
        dataclasses.replace(surf, patch_valid=keep))


def delete_patches(surf: Surface, delete_mask: torch.Tensor) -> Surface:
    return dataclasses.replace(surf,
                               patch_valid=surf.patch_valid & ~delete_mask)


def update_nodes(surf: Surface, delta: torch.Tensor) -> Surface:
    """Apply a solver step [(V,) ny+1, nx+1, 4] to valid nodes
    (reference :957-981)."""
    nodes = torch.where(surf.node_valid[..., None], surf.nodes + delta,
                        surf.nodes)
    return dataclasses.replace(surf, nodes=nodes)


# ---------------------------------------------------------------------------
# expansion


_NEIGHBOR_OFFSETS = [(-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                     (-1, 1), (0, 1), (1, 1)]  # (dx, dy), reference order 0-7


def _shift_node_field(arr: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Value of the node at offset (dx, dy) from each node of ``arr``
    [ny1, nx1, C]; out-of-bounds neighbors are zero."""
    pad = _pad2(arr, 1, 1, 1, 1)
    ny1, nx1 = arr.shape[:2]
    return pad[1 + dy : 1 + dy + ny1, 1 + dx : 1 + dx + nx1]


@over_views
def expand(surf: Surface) -> Surface:
    """Grow the surface border (reference `Surface::expand`, :483-628).

    Two sweeps; in each, every node that was invalid before the expand
    receives candidate depths extrapolated from 8 directional neighbor
    triples, resolved by the reference's ``check_swap_nodes`` rule (take
    the new candidate when it is > 10% deeper, :472-480). New nodes carry
    zero derivatives. Afterwards: fill holes, then prune danglers. The
    same arithmetic, in the same order, as the JAX package.
    """
    orig_valid = surf.node_valid
    node_valid = surf.node_valid
    nodes = surf.nodes
    cand_f = torch.zeros(node_valid.shape, dtype=nodes.dtype,
                         device=nodes.device)
    cand_has = torch.zeros_like(node_valid)
    process = ~orig_valid  # null or created-this-expand nodes

    for _ in range(2):
        field = torch.cat([nodes * node_valid[..., None],
                           node_valid[..., None].to(nodes.dtype)], dim=-1)
        f, gx, gy, ok = {}, {}, {}, {}
        for k, (dx, dy) in enumerate(_NEIGHBOR_OFFSETS):
            sh = _shift_node_field(field, dx, dy)
            f[k], gx[k], gy[k] = sh[..., 0], sh[..., 1], sh[..., 2]
            ok[k] = sh[..., 4] > 0.5

        rules = [
            # (required neighbor ids, candidate value)
            ((0, 1, 3), ((f[3] + gx[3] / 2) + (f[1] + gy[1] / 2)) / 2),
            ((1, 2, 4), ((f[4] - gx[4] / 2) + (f[1] + gy[1] / 2)) / 2),
            ((3, 5, 6), ((f[3] + gx[3] / 2) + (f[6] - gy[6] / 2)) / 2),
            ((4, 6, 7), ((f[4] - gx[4] / 2) + (f[6] - gy[6] / 2)) / 2),
            ((0, 1, 2), (f[0] + gy[0] / 2 + f[1] + gy[1] / 2
                         + f[2] + gy[2] / 2) / 3),
            ((0, 3, 5), (f[0] + gx[0] / 2 + f[3] + gx[3] / 2
                         + f[5] + gx[5] / 2) / 3),
            ((5, 6, 7), (f[5] - gy[5] / 2 + f[6] - gy[6] / 2
                         + f[7] - gy[7] / 2) / 3),
            ((2, 4, 7), (f[2] - gx[2] / 2 + f[4] - gx[4] / 2
                         + f[7] - gx[7] / 2) / 3),
        ]
        for req, value in rules:
            cond = process
            for r in req:
                cond = cond & ok[r]
            take = cond & (~cand_has | (value * 0.9 > cand_f))
            cand_f = torch.where(take, value, cand_f)
            cand_has = cand_has | take

        # merge the candidates into the working node set (reference
        # :616-618)
        newly = cand_has & ~orig_valid
        new_vals = torch.stack([cand_f, torch.zeros_like(cand_f),
                                torch.zeros_like(cand_f),
                                torch.zeros_like(cand_f)], dim=-1)
        nodes = torch.where(newly[..., None], new_vals, nodes)
        node_valid = node_valid | newly

    surf = dataclasses.replace(surf, nodes=nodes, node_valid=node_valid)
    return remove_nodes_without_patch(fill_holes(surf))


# ---------------------------------------------------------------------------
# evaluation


def patch_params(surf: Surface) -> torch.Tensor:
    """Node-major params16 per patch: [(V,) ny, nx, 16], node order
    (00, 10, 01, 11) with 10 = +x (reference `lib/surface.cc:290-298`)."""
    n = surf.nodes
    return torch.cat([n[..., :-1, :-1, :], n[..., :-1, 1:, :],
                      n[..., 1:, :-1, :], n[..., 1:, 1:, :]], dim=-1)


def _rasterize(surf: Surface, vals: torch.Tensor) -> torch.Tensor:
    """Per-patch pixel values [ny, nx, ps*ps, C] -> image [H, W, C]."""
    ps = surf.patchsize
    ny, nx = surf.num_patches_y, surf.num_patches_x
    c = vals.shape[-1]
    block = vals.reshape(ny, nx, ps, ps, c).permute(0, 2, 1, 3, 4).reshape(
        ny * ps, nx * ps, c)
    out = torch.zeros((surf.height, surf.width, c), dtype=vals.dtype,
                      device=vals.device)
    out[surf.start_y:surf.start_y + ny * ps,
        surf.start_x:surf.start_x + nx * ps] = block
    return out


@over_views
def depth_map(surf: Surface) -> torch.Tensor:
    """Rasterize patch depths into [H, W]; invalid regions are 0
    (reference `Surface::get_depth_map`, :155-168)."""
    basis_f = bicubic.pixel_basis(surf.patchsize, dtype=surf.nodes.dtype,
                                  device=surf.nodes.device)[:, 0, :]
    vals = patch_params(surf) @ basis_f.T  # [ny, nx, P]
    vals = vals * surf.patch_valid[..., None]
    return _rasterize(surf, vals[..., None])[..., 0]


def depth_and_derivs(surf: Surface) -> torch.Tensor:
    """[ny, nx, P, 6] per-pixel (f, dx, dy, dxy, dxx, dyy) in pixel units."""
    basis = bicubic.pixel_basis(surf.patchsize, dtype=surf.nodes.dtype,
                                device=surf.nodes.device)
    P = basis.shape[0]
    vals = patch_params(surf) @ basis.reshape(P * 6, 16).T
    return vals.reshape(*vals.shape[:2], P, 6)


@over_views
def normal_map(surf: Surface, inv_flen: float) -> torch.Tensor:
    """Rasterize unit normals into [H, W, 3] (reference :170-183)."""
    ps = surf.patchsize
    vals = depth_and_derivs(surf)  # [ny, nx, P, 6]
    ny, nx = surf.num_patches_y, surf.num_patches_x
    ii = np.arange(ps)
    px, py = np.meshgrid(ii, ii, indexing="xy")
    px = px.reshape(-1)
    py = py.reshape(-1)
    gx = (surf.start_x + np.arange(nx)[:, None] * ps + px[None, :] + 0.5
          - surf.width / 2.0)
    gy = (surf.start_y + np.arange(ny)[:, None] * ps + py[None, :] + 0.5
          - surf.height / 2.0)
    dt, dev = surf.nodes.dtype, surf.nodes.device
    x = torch.as_tensor(gx, dtype=dt, device=dev)[None, :, :]
    y = torch.as_tensor(gy, dtype=dt, device=dev)[:, None, :]
    n = nrm.normal(x, y, inv_flen, vals[..., 0], vals[..., 1], vals[..., 2])
    n = n * surf.patch_valid[..., None, None]
    return _rasterize(surf, n)


# ---------------------------------------------------------------------------
# subdivision


def _interleave_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [R, C+1, ...], b [R, C, ...] -> [R, 2C+1, ...] alternating."""
    bp = _pad2(b, 0, 0, 0, 1)
    out = torch.stack([a, bp], dim=2)  # [R, C+1, 2, ...]
    return out.reshape(a.shape[0], 2 * a.shape[1], *a.shape[2:])[:, :-1]


def _interleave_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [R+1, C, ...], b [R, C, ...] -> [2R+1, C, ...] alternating."""
    bp = _pad2(b, 0, 1, 0, 0)
    out = torch.stack([a, bp], dim=1)  # [R+1, 2, C, ...]
    return out.reshape(2 * a.shape[0], *a.shape[1:])[:-1]


@over_views
def subdivide(surf: Surface) -> Surface:
    """Halve the scale (reference `Surface::subdivide_patches`, :984-1107).

    Old nodes land on even grid positions with dx/2, dy/2, dxy/4; each
    valid patch spawns 5 midpoint nodes by bicubic evaluation; conflicting
    edge writes resolve like the reference's last-writer-wins patch loop.
    """
    ps = surf.patchsize
    new_ps = ps // 2
    new_scale = surf.scale - 1
    nx, ny = surf.num_patches_x, surf.num_patches_y
    dt, dev = surf.nodes.dtype, surf.nodes.device

    cand_nx = (surf.width - 2) // new_ps
    cand_ny = (surf.height - 2) // new_ps
    off_x = cand_nx - nx * 2
    off_y = cand_ny - ny * 2
    start_x, start_y = surf.start_x, surf.start_y
    if off_x >= 2:
        new_nx = nx * 2 + 2
        start_x = (surf.width - new_nx * new_ps) // 2
        off_x = 1
    else:
        off_x = 0
        new_nx = nx * 2
    if off_y >= 2:
        new_ny = ny * 2 + 2
        start_y = (surf.height - new_ny * new_ps) // 2
        off_y = 1
    else:
        off_y = 0
        new_ny = ny * 2

    params = patch_params(surf)  # [ny, nx, 16]
    pts = torch.as_tensor(
        [[0.5, 0.0], [0.0, 0.5], [0.5, 0.5], [1.0, 0.5], [0.5, 1.0]],
        dtype=dt, device=dev)
    rows = bicubic.basis_rows(pts[:, 0], pts[:, 1])  # [5, 6, 16]
    vals = (params @ rows[:, :4, :].reshape(20, 16).T).reshape(ny, nx, 5, 4)
    scale_vec = torch.as_tensor([1.0, 0.5, 0.5, 0.25], dtype=dt, device=dev)
    vals = vals * scale_vec  # new-node derivative rescale (reference :1039-1071)
    pv = surf.patch_valid

    old_scaled = torch.where(surf.node_valid[..., None],
                             surf.nodes * scale_vec, 0.0)  # [ny+1, nx+1, 4]
    center = torch.where(pv[..., None], vals[:, :, 2, :], 0.0)  # [ny, nx, 4]
    # Horizontal-edge midpoints (even row, odd col): top-edge eval of the
    # patch below, else bottom-edge eval of the patch above.
    vr = _pad2(vals, 1, 1, 0, 0)
    pr = _pad2(pv, 1, 1, 0, 0)
    top, top_ok = vr[1:, :, 0, :], pr[1:, :]
    bot, bot_ok = vr[:-1, :, 4, :], pr[:-1, :]
    hval = torch.where(top_ok[..., None], top,
                       torch.where(bot_ok[..., None], bot, 0.0))
    hvalid = top_ok | bot_ok  # [ny+1, nx]
    # Vertical-edge midpoints (odd row, even col): left-edge eval of the
    # patch to the right, else right-edge eval of the left one.
    vc = _pad2(vals, 0, 0, 1, 1)
    pc = _pad2(pv, 0, 0, 1, 1)
    left, left_ok = vc[:, 1:, 1, :], pc[:, 1:]
    right, right_ok = vc[:, :-1, 3, :], pc[:, :-1]
    vvval = torch.where(left_ok[..., None], left,
                        torch.where(right_ok[..., None], right, 0.0))
    vvalid = left_ok | right_ok  # [ny, nx+1]

    even_rows = _interleave_cols(old_scaled, hval)  # [ny+1, 2nx+1, 4]
    odd_rows = _interleave_cols(vvval, center)  # [ny, 2nx+1, 4]
    core = _interleave_rows(even_rows, odd_rows)  # [2ny+1, 2nx+1, 4]
    even_v = _interleave_cols(surf.node_valid, hvalid)
    odd_v = _interleave_cols(vvalid, pv)
    core_valid = _interleave_rows(even_v, odd_v)

    pads = (off_y, new_ny + 1 - (2 * ny + 1) - off_y,
            off_x, new_nx + 1 - (2 * nx + 1) - off_x)
    new_surf = Surface(
        nodes=_pad2(core, *pads),
        node_valid=_pad2(core_valid, *pads),
        patch_valid=torch.zeros((new_ny, new_nx), dtype=torch.bool,
                                device=dev),
        scale=new_scale, width=surf.width, height=surf.height,
        start_x=start_x, start_y=start_y,
    )
    new_surf = fill_holes(new_surf)
    return remove_nodes_without_patch(new_surf)
