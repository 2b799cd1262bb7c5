"""Neighbor view selection (numpy, host side; port of
`smvs_tpu/pipeline/view_selection.py`, reference `lib/view_selection.cc`).

Bundle-based selection counts SfM features shared
with each of the 50 nearest cameras whose pixel-footprint ratio exceeds 0.6,
keeps views with > 10 matches, top-``num_neighbors``; without a bundle,
falls back to nearest cameras with compatible viewing directions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from smvs_tpu_torch.core.camera import Camera
from smvs_tpu_torch.core.scene import Bundle


@dataclasses.dataclass
class ViewSelectionOptions:
    """Mirror of `ViewSelection::Options` (reference `lib/view_selection.h:22-27`)."""

    num_neighbors: int = 6


def _sorted_by_distance(cameras: list[Camera | None], view: int) -> list[int]:
    """Indices of other valid views sorted by camera-center distance

    (reference :134-160)."""
    main = cameras[view]
    pos = main.cam_position()
    out = []
    for i, cam in enumerate(cameras):
        if i == view or cam is None or cam.flen == 0.0:
            continue
        out.append((float(np.linalg.norm(pos - cam.cam_position())), i))
    out.sort()
    return [i for _, i in out]


def bundle_based_selection(
    cameras: list[Camera | None],
    sizes: list[tuple[int, int]],  # (width, height) per view
    bundle: Bundle,
    view: int,
    opts: ViewSelectionOptions = ViewSelectionOptions(),
) -> list[int]:
    """Reference `lib/view_selection.cc:23-96`. Returns neighbor view ids."""
    main = cameras[view]
    if main is None:
        return []
    w, h = sizes[view]
    inv0 = main.inverse_calibration(w, h)[0, 0]

    feats = [f for f in bundle.features if view in f.refs]
    if not feats:
        return []
    pos = np.stack([f.pos for f in feats])
    main_depth = main.world_to_cam(pos)[:, 2]
    main_footprint = main_depth * inv0

    candidates = _sorted_by_distance(cameras, view)[:50]
    scored = []
    for i in candidates:
        cam = cameras[i]
        wi, hi = sizes[i]
        inv_i = cam.inverse_calibration(wi, hi)[0, 0]
        nb_depth = cam.world_to_cam(pos)[:, 2]
        nb_footprint = nb_depth * inv_i
        shares = np.asarray([i in f.refs for f in feats])
        lo = np.minimum(nb_footprint, main_footprint)
        hi_ = np.maximum(nb_footprint, main_footprint)
        ratio_ok = np.where(hi_ != 0, lo / np.where(hi_ == 0, 1, hi_), 0) > 0.6
        n_matches = int(np.sum(shares & ratio_ok))
        scored.append((n_matches, i))
    scored.sort(key=lambda t: -t[0])

    neighbors = []
    for n_matches, i in scored:
        if n_matches > 10:
            neighbors.append(i)
        if len(neighbors) >= opts.num_neighbors:
            break
    return neighbors


def position_based_selection(
    cameras: list[Camera | None],
    view: int,
    opts: ViewSelectionOptions = ViewSelectionOptions(),
) -> list[int]:
    """No-bundle fallback (reference :98-132): nearest cameras with viewing
    direction dot > 0.65 and consistent 'up' (third rotation column)."""
    main = cameras[view]
    main_dir = main.viewing_direction()
    main_up = main.rot[:, 2]
    out = []
    for i in _sorted_by_distance(cameras, view):
        cam = cameras[i]
        if np.dot(main_up, cam.rot[:, 2]) < 0:
            continue
        if np.dot(main_dir, cam.viewing_direction()) < 0.65:
            continue
        out.append(i)
    return out[: opts.num_neighbors] if opts.num_neighbors else out


def get_neighbors_for_view(
    cameras: list[Camera | None],
    sizes: list[tuple[int, int]],
    bundle: Bundle | None,
    view: int,
    opts: ViewSelectionOptions = ViewSelectionOptions(),
) -> list[int]:
    if bundle is not None:
        return bundle_based_selection(cameras, sizes, bundle, view, opts)
    return position_based_selection(cameras, view, opts)
