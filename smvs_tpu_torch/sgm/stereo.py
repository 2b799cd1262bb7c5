"""Semi-global matching depth initialization (port of
`smvs_tpu/sgm/stereo.py`, reference `lib/sgm_stereo.cc`).

- 9x7 census transform held as one int64 word of 63 bits (the JAX
  package packs the same bits into two uint32 words);
- the rectified path (`reconstruct_rectified`): per-plane census Hamming
  cost over fractional x-shifts of the rectified neighbor (or, with
  `SGMOptions.cost_interp`, the Hamming costs of the integer shifts
  interpolated, one census per image), both SGM
  directions aggregated in one `cuda_agg.aggregate_batch` call, sub-pixel
  WTA, bidirectional consistency and un-rectify;
- the general-warp path (`reconstruct`) for pairs that do not rectify
  (near-forward motion): per-plane warp, bilinear sample, census and
  Hamming cost, `cuda_agg.aggregate` per direction, WTA and the
  reference's integer-coordinate consistency filter;
- `reconstruct_auto` picks between the two, and `reconstruct_auto_multi`
  averages the depth maps of several neighbors.

Cost volumes are built plane group by plane group into int16; the 8-path
aggregation runs the CUDA kernel on the card and its plain twin on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.sgm import cuda_agg
from smvs_tpu_torch.sgm import rectify as R
from smvs_tpu_torch.utils.timing import host_reads, span

INVALID_COST = 255  # reference fills missing warps with 255 (:216-221)

# Planes per census/Hamming group in `_disparity_cost` (bounds the int64
# temporaries to a few hundred MB at 2 MP).
_PLANE_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class SGMOptions:
    """Mirror of `SGMStereo::Options` (reference `lib/sgm_stereo.h:24-34`)."""

    scale: int = 1
    num_steps: int = 128
    debug_lvl: int = 0
    min_depth: float = 0.0
    max_depth: float = 0.0
    penalty1: int = 6
    penalty2: int = 96
    # Cost-space interpolation of the rectified sweep
    # (`_disparity_cost_interp`); the general warp ignores it.
    cost_interp: bool = False


def depth_planes(min_depth: float, max_depth: float, num_steps: int
                 ) -> np.ndarray:
    """Inverse-depth sweep values (reference :193-203)."""
    inv = np.linspace(1.0 / max_depth, 1.0 / min_depth, num_steps)
    return (1.0 / inv).astype(np.float32)


def census_transform(img: torch.Tensor) -> torch.Tensor:
    """9(x) x 7(y) census over [..., H, W] intensities -> int64 words.

    Bit order follows reference :126-148 (x-major over the window, first
    comparison in the most significant of the 63 bits), so the word equals
    the JAX package's ``(hi << 32) | lo``. Pixels with value 0 and the
    border band get 0.
    """
    h, w = img.shape[-2:]
    pad = torch.nn.functional.pad(img, (4, 4, 3, 3))
    word = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    for dx in range(-4, 5):
        for dy in range(-3, 4):
            nb = pad[..., 3 + dy : 3 + dy + h, 4 + dx : 4 + dx + w]
            word = (word << 1) | (img < nb).to(torch.int64)
    ys = torch.arange(h, device=img.device)
    xs = torch.arange(w, device=img.device)
    interior = ((xs >= 4) & (xs < w - 5))[None, :] & \
        ((ys >= 3) & (ys < h - 4))[:, None]
    valid = interior & (img != 0)
    return torch.where(valid, word, 0)


_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F


def _popcount63(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int64 words (SWAR; torch has no popcount).

    The byte sums are folded with shifts instead of the usual multiply,
    so no step overflows a signed 64-bit word.
    """
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(torch.int32)


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance of two census words, int32."""
    return _popcount63(a ^ b)


def _disparity_cost(m_census: torch.Tensor, nbr_img: torch.Tensor,
                    shifts: torch.Tensor, out: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Census Hamming cost volume [H, W, D] (int16) over fractional x-shifts.

    Per plane the neighbor is shifted by ``shifts[d]`` (a 2-tap blend of
    two slices), census-transformed and matched against the main census;
    unwarpable positions get INVALID_COST. The slice start is clipped to
    ``[1, P + wn]`` exactly as the JAX version clips it, so its
    ``dynamic_slice`` clamp never fires. ``out`` may be a [H, W, D] int16
    view to fill in place.
    """
    h, w = m_census.shape
    wn = nbr_img.shape[1]
    D = shifts.shape[0]
    P = w + wn  # padding covers any |shift| the clip admits
    pimg = torch.nn.functional.pad(nbr_img, (P, P))
    si = torch.floor(shifts).to(torch.int32)
    frac = (shifts - si.to(shifts.dtype)).to(nbr_img.dtype)
    starts = torch.clamp(P - si, 1, P + wn).tolist()
    host_reads["shifts"] += 1
    if out is None:
        out = torch.empty((h, w, D), dtype=torch.int16, device=nbr_img.device)
    for c0 in range(0, D, _PLANE_CHUNK):
        c1 = min(D, c0 + _PLANE_CHUNK)
        t0 = torch.stack([pimg[:, s : s + w] for s in starts[c0:c1]])
        t1 = torch.stack([pimg[:, s - 1 : s - 1 + w] for s in starts[c0:c1]])
        a = frac[c0:c1, None, None]
        warped = torch.where((t0 != 0) & (t1 != 0),
                             iops.fma(1 - a, t0, a * t1), 0.0)
        cost = _hamming(m_census, census_transform(warped))
        cost = torch.where(warped != 0, cost, INVALID_COST)
        out[..., c0:c1] = cost.permute(1, 2, 0).to(torch.int16)
    return out


def _disparity_cost_interp(m_census: torch.Tensor, nbr_img: torch.Tensor,
                           shifts: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """`_disparity_cost` by cost-space interpolation: the neighbor's census
    is taken once, and each plane lerps the Hamming costs at its two
    bracketing integer shifts by the fractional part and rounds (half to
    even, as `jnp.round`), which skips the per-plane census transforms.
    Validity as in the blend path: both tapped samples nonzero."""
    h, w = m_census.shape
    wn = nbr_img.shape[1]
    D = shifts.shape[0]
    P = w + wn
    pimg = torch.nn.functional.pad(nbr_img, (P, P))
    pcen = torch.nn.functional.pad(census_transform(nbr_img), (P, P))
    si = torch.floor(shifts).to(torch.int32)
    frac = shifts - si.to(shifts.dtype)
    starts = torch.clamp(P - si, 1, P + wn).tolist()
    host_reads["shifts"] += 1
    if out is None:
        out = torch.empty((h, w, D), dtype=torch.int16, device=nbr_img.device)
    for c0 in range(0, D, _PLANE_CHUNK):
        c1 = min(D, c0 + _PLANE_CHUNK)

        def taps(img, k):
            return torch.stack([img[:, s - k : s - k + w]
                                for s in starts[c0:c1]])

        a = frac[c0:c1, None, None]
        cost0 = _hamming(m_census, taps(pcen, 0)).to(a.dtype)
        cost1 = _hamming(m_census, taps(pcen, 1)).to(a.dtype)
        cost = torch.round((1 - a) * cost0 + a * cost1)
        cost = torch.where((taps(pimg, 0) != 0) & (taps(pimg, 1) != 0),
                           cost.to(torch.int32), INVALID_COST)
        out[..., c0:c1] = cost.permute(1, 2, 0).to(torch.int16)
    return out


def _warp_fma(M: torch.Tensor, t: torch.Tensor, u, v, w):
    """`correspondence.warp` rounded as XLA compiles it in the JAX general
    path: the linear forms in plain float32, then ``w * form + t`` as one
    fused multiply-add. Returns (px, py, depth) with px/py the projected
    pixel coordinates."""
    p = M[0, 0] * u + M[0, 1] * v + M[0, 2]
    q = M[1, 0] * u + M[1, 1] * v + M[1, 2]
    r = M[2, 0] * u + M[2, 1] * v + M[2, 2]
    a = iops.fma(w, p, t[0])
    b = iops.fma(w, q, t[1])
    d = iops.fma(w, r, t[2])
    return a / d, b / d, d


def cost_volume(main_img: torch.Tensor, neighbor_img: torch.Tensor,
                M: torch.Tensor, t: torch.Tensor, depths: torch.Tensor
                ) -> torch.Tensor:
    """Census Hamming cost volume [H, W, D] int16 of the general warp
    (reference :193-244).

    Per depth plane the main pixel centers are warped into the neighbor
    through (M, t), the neighbor is sampled bilinearly, census-transformed
    and matched against the main census; samples outside the neighbor get
    INVALID_COST. Built plane group by plane group, so the temporaries
    stay at a few hundred MB at 2 MP; float32 throughout.
    """
    h, w = main_img.shape
    hn, wn = neighbor_img.shape
    dev = main_img.device
    f32 = main_img.dtype
    M = M.to(device=dev, dtype=f32)
    t = t.to(device=dev, dtype=f32)
    depths = depths.to(device=dev, dtype=f32)
    m_census = census_transform(main_img)
    nbr_win4 = iops.pack_window4(neighbor_img)
    u = torch.arange(w, device=dev).to(f32)[None, :] + 0.5
    v = torch.arange(h, device=dev).to(f32)[:, None] + 0.5
    D = depths.shape[0]
    out = torch.empty((h, w, D), dtype=torch.int16, device=dev)
    for c0 in range(0, D, _PLANE_CHUNK):
        d = depths[c0 : c0 + _PLANE_CHUNK, None, None]
        px, py, depth_n = _warp_fma(M, t, u, v, d)
        px = px - 0.5
        py = py - 0.5
        ok = (depth_n > 0) & (px >= 0) & (py >= 0) & (px <= wn - 1) & \
            (py <= hn - 1)
        warped = torch.where(ok, iops.bilinear_packed4_fma(nbr_win4, px, py),
                             0.0)
        cost = _hamming(m_census, census_transform(warped))
        cost = torch.where(warped != 0, cost, INVALID_COST)
        out[..., c0 : c0 + d.shape[0]] = cost.permute(1, 2, 0).to(torch.int16)
    return out


def winner_take_all(sgm_volume: torch.Tensor, intensity: torch.Tensor,
                    depths: torch.Tensor) -> torch.Tensor:
    """WTA depth (reference `depth_from_sgm_volume`, :274-306): rejects
    the two lowest planes and dark pixels (< 25/255). `torch.argmin` takes
    the first of tied minima, as `jnp.argmin` does."""
    idx = torch.argmin(sgm_volume, dim=-1)
    depth = depths.to(intensity.device)[idx]
    ok = (idx >= 2) & (intensity >= 25)
    return torch.where(ok, depth, 0.0)


def run_sgm(main_img: torch.Tensor, neighbor_img: torch.Tensor,
            M: torch.Tensor, t: torch.Tensor, min_depth: float,
            max_depth: float, opts: SGMOptions) -> torch.Tensor:
    """Single-direction SGM depth map (reference `run_sgm`, :98-124).

    The cost volume is freed before the caller runs the other direction.
    """
    depths = torch.as_tensor(
        depth_planes(min_depth, max_depth, opts.num_steps),
        device=main_img.device)
    with span("sgm.cost"):
        cost = cost_volume(main_img, neighbor_img, M, t, depths)
    with span("sgm.aggregate"):
        agg = cuda_agg.aggregate(cost, main_img.to(torch.int32),
                                 opts.penalty1, opts.penalty2)
    del cost
    with span("sgm.wta"):
        return winner_take_all(agg, main_img, depths)


def consistency_filter(d_main: torch.Tensor, d_neig: torch.Tensor,
                       M: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Bidirectional consistency (reference `reconstruct`, :64-91): zero
    pixels whose reprojection misses the neighbor (3% border) or whose
    depth ratio with the neighbor's estimate is < 0.8.

    Like the reference (:77) and the JAX package, it warps integer pixel
    coordinates (no +0.5) and truncates the projection to a pixel.
    """
    h, w = d_main.shape
    hn, wn = d_neig.shape
    dev = d_main.device
    f32 = d_main.dtype
    cut = 0.03 * max(wn, hn)
    xs = torch.arange(w, device=dev).to(f32)[None, :]
    ys = torch.arange(h, device=dev).to(f32)[:, None]
    px, py, cdepth = _warp_fma(M.to(device=dev, dtype=f32),
                               t.to(device=dev, dtype=f32), xs, ys, d_main)
    inb = (px >= cut) & (px < wn - cut) & (py >= cut) & (py < hn - cut)
    cx = torch.clamp(px.to(torch.int32), 0, wn - 1).to(torch.int64)
    cy = torch.clamp(py.to(torch.int32), 0, hn - 1).to(torch.int64)
    ndepth = d_neig[cy, cx]
    ratio = torch.minimum(cdepth, ndepth) / torch.clamp(
        torch.maximum(cdepth, ndepth), min=1e-20)
    ok = (d_main > 0) & inb & (ndepth > 0) & (ratio >= 0.8)
    return torch.where(ok, d_main, 0.0)


def reconstruct(main_img: torch.Tensor, neighbor_img: torch.Tensor,
                M_mn: torch.Tensor, t_mn: torch.Tensor, M_nm: torch.Tensor,
                t_nm: torch.Tensor, range_main: tuple[float, float],
                range_neighbor: tuple[float, float],
                opts: SGMOptions = SGMOptions()) -> torch.Tensor:
    """Bidirectional SGM through the general warp (reference
    `SGMStereo::reconstruct`, :46-96).

    Images are [H, W] intensities on a 0..255 scale on the device to run
    on; (M_mn, t_mn) warps main -> neighbor, (M_nm, t_nm) the reverse.
    Depth ranges are per-view sweep bounds.
    """
    d_main = run_sgm(main_img, neighbor_img, M_mn, t_mn, *range_main, opts)
    d_neig = run_sgm(neighbor_img, main_img, M_nm, t_nm, *range_neighbor,
                     opts)
    with span("sgm.consistency"):
        return consistency_filter(d_main, d_neig, M_mn, t_mn)


def depth_range_from_features(feature_depths: np.ndarray
                              ) -> tuple[float, float]:
    """SfM-feature-based sweep range (reference :669-720)."""
    d = np.sort(np.asarray(feature_depths))
    if d.size < 2:
        return 0.3, 1.1
    return float(d[0] * 0.7), float(d[(d.size * 99) // 100] * 5.0)


def _at_plane(vol: torch.Tensor, idx: torch.Tensor, offset: int
              ) -> torch.Tensor:
    """vol[y, x, idx[y, x] + offset] with the plane index clipped."""
    d = vol.shape[-1]
    want = torch.clamp(idx + offset, 0, d - 1)
    return vol.gather(-1, want[..., None])[..., 0]


def _wta_subpixel(agg: torch.Tensor, raw_cost: torch.Tensor,
                  intensity: torch.Tensor, disp0, dstep):
    """WTA + parabolic sub-plane refinement -> (disparity, valid).

    Rejects the two lowest sweep planes, dark pixels, and winners without
    a real raw matching cost (reference `depth_from_sgm_volume`, :274-306).
    """
    f32 = torch.float32
    idx = torch.argmin(agg, dim=-1)
    c0 = _at_plane(agg, idx, 0).to(f32)
    cm = _at_plane(agg, idx, -1).to(f32)
    cp = _at_plane(agg, idx, 1).to(f32)
    denom = cm + cp - 2.0 * c0
    frac = torch.where(denom > 1e-6,
                       0.5 * (cm - cp) / torch.clamp(denom, min=1e-6), 0.0)
    d = agg.shape[-1]
    frac = torch.where((idx > 0) & (idx < d - 1),
                       torch.clamp(frac, -0.5, 0.5), 0.0)
    disp = disp0 + dstep * (idx.to(f32) + frac)
    matched = _at_plane(raw_cost, idx, 0) < INVALID_COST
    ok = (idx >= 2) & (intensity >= 25) & matched
    return disp, ok


def _rectified_sgm(main_r, nbr_r, hinv_nbr, H_main, L_main, fB, off,
                   disp0, dstep, shifts, p1: int, p2: int,
                   cost_interp: bool = False) -> torch.Tensor:
    """Bidirectional SGM in the rectified frame -> main-view z-depth.

    main_r [H, W] / nbr_r [H, W + 2*nbr_pad]: rectified intensities (0..255,
    0 = outside the original image). H_main maps original main pixel
    centers to rectified ones; hinv_nbr maps rectified-neighbor coords back
    to the original neighbor frame (for the 3% border cut); L_main turns
    rectified depth into main z-depth.
    """
    h, w = main_r.shape
    wn = nbr_r.shape[1]
    D = shifts.shape[0]
    dev = main_r.device

    with span("sgm.cost"):
        m_c = census_transform(main_r)
        n_c = census_transform(nbr_r)

        # Both directions ride one batched aggregation; the main problem
        # is padded to the widened neighbor canvas with INVALID columns,
        # which leave the real columns' path costs unchanged (a uniform
        # previous line restarts the recurrence).
        vol = torch.full((2, h, wn, D), INVALID_COST, dtype=torch.int16,
                         device=dev)
        cost_fn = _disparity_cost_interp if cost_interp else _disparity_cost
        cost_fn(m_c, nbr_r, shifts, out=vol[0, :, :w])
        cost_fn(n_c, main_r, -shifts, out=vol[1])
    with span("sgm.aggregate"):
        im = torch.nn.functional.pad(main_r, (0, wn - w))
        inten = torch.stack([im, nbr_r]).to(torch.int32)
        agg2 = cuda_agg.aggregate_batch(vol, inten, p1, p2)
    with span("sgm.wta"):
        disp_m, ok_m = _wta_subpixel(agg2[0, :, :w], vol[0, :, :w], main_r,
                                     disp0, dstep)
        disp_n, ok_n = _wta_subpixel(agg2[1], vol[1], nbr_r, disp0, dstep)
    del agg2, vol
    with span("sgm.consistency"):
        return _consistent_depth(disp_m, ok_m, disp_n, ok_n, hinv_nbr,
                                 H_main, L_main, fB, off, wn, main_r.dtype)


def _consistent_depth(disp_m, ok_m, disp_n, ok_n, hinv_nbr, H_main, L_main,
                      fB, off, wn: int, f32) -> torch.Tensor:
    """`_rectified_sgm`'s bidirectional consistency test and un-rectify:
    the main view's z-depth from both directions' disparities [H, W] and
    [H, wn] and their validity, computed in ``f32``."""
    h, w = disp_m.shape
    dev = disp_m.device

    # Bidirectional consistency (reference `reconstruct`, :64-91): the
    # matched neighbor pixel must see a compatible depth (ratio >= 0.8)
    # and lie inside a 3% border margin of the ORIGINAL neighbor frame.
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    yf = ys.to(f32)
    cut = 0.03 * max(w, h)
    xn = xs.to(f32) - disp_m
    Hn = hinv_nbr.to(f32)
    un_h = Hn[0, 0] * (xn + 0.5) + Hn[0, 1] * (yf + 0.5) + Hn[0, 2]
    vn_h = Hn[1, 0] * (xn + 0.5) + Hn[1, 1] * (yf + 0.5) + Hn[1, 2]
    zn_h = Hn[2, 0] * (xn + 0.5) + Hn[2, 1] * (yf + 0.5) + Hn[2, 2]
    uo = un_h / zn_h - 0.5
    vo = vn_h / zn_h - 0.5
    inb = (zn_h > 0) & (uo >= cut) & (uo < w - cut) & \
        (vo >= cut) & (vo < h - cut)
    # Sub-pixel consistency along the epipolar line.
    x0 = torch.clamp(torch.floor(xn).to(torch.int64), 0, wn - 2)
    fx = torch.clamp(xn - x0.to(f32), 0.0, 1.0)
    dn0 = disp_n[ys, x0]
    dn1 = disp_n[ys, x0 + 1]
    okn0 = ok_n[ys, x0]
    okn1 = ok_n[ys, x0 + 1]
    disp_n_at = torch.where(okn0 & okn1, dn0 * (1.0 - fx) + dn1 * fx,
                            torch.where(okn0, dn0, dn1))
    ok_n_at = okn0 | okn1
    zm_rect = fB / torch.where(torch.abs(disp_m - off) > 1e-9, disp_m - off,
                               1e9)
    zn_rect = fB / torch.where(torch.abs(disp_n_at - off) > 1e-9,
                               disp_n_at - off, 1e9)
    ratio = torch.minimum(zm_rect, zn_rect) / torch.clamp(
        torch.maximum(zm_rect, zn_rect), min=1e-20)
    good = ok_m & ok_n_at & inb & (zm_rect > 0) & (zn_rect > 0) & \
        (ratio >= 0.8)
    z_rect = torch.where(good, zm_rect, 0.0)

    # Un-rectify: each original main pixel reads the rectified depth at
    # its homography image and converts to main-camera z-depth.
    Hc = H_main.to(f32)
    u = xs.to(f32) + 0.5
    v = yf + 0.5
    rx = Hc[0, 0] * u + Hc[0, 1] * v + Hc[0, 2]
    ry = Hc[1, 0] * u + Hc[1, 1] * v + Hc[1, 2]
    rz = Hc[2, 0] * u + Hc[2, 1] * v + Hc[2, 2]
    rx = rx / rz
    ry = ry / rz
    # Validity-weighted bilinear over the 2x2 support when the valid
    # samples agree; else the nearest sample.
    gx = rx - 0.5
    gy = ry - 0.5
    gx0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, w - 2)
    gy0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, h - 2)
    gfx = torch.clamp(gx - gx0.to(f32), 0.0, 1.0)
    gfy = torch.clamp(gy - gy0.to(f32), 0.0, 1.0)
    z4 = torch.stack([z_rect[gy0, gx0], z_rect[gy0, gx0 + 1],
                      z_rect[gy0 + 1, gx0], z_rect[gy0 + 1, gx0 + 1]])
    w4 = torch.stack([(1 - gfx) * (1 - gfy), gfx * (1 - gfy),
                      (1 - gfx) * gfy, gfx * gfy])
    m4 = (z4 > 0).to(f32)
    wsum = (w4 * m4).sum(0)
    zbar = (w4 * m4 * z4).sum(0) / torch.clamp(wsum, min=1e-12)
    zmin = torch.where(m4 > 0, z4, torch.inf).amin(0)
    zmax = torch.where(m4 > 0, z4, 0.0).amax(0)
    agree = zmin >= 0.8 * zmax
    rxi = torch.clamp(torch.round(gx).to(torch.int64), 0, w - 1)
    ryi = torch.clamp(torch.round(gy).to(torch.int64), 0, h - 1)
    z_nn = z_rect[ryi, rxi]
    z_at = torch.where((wsum > 0.5) & agree, zbar, z_nn)
    inb_r = (rz > 0) & (rx >= 0.5) & (rx <= w - 0.5) & (ry >= 0.5) & \
        (ry <= h - 0.5)
    Lc = L_main.to(f32)
    depth = z_at * (Lc[0] * rx + Lc[1] * ry + Lc[2])
    return torch.where(inb_r & (z_at > 0) & (depth > 0), depth, 0.0)


def _rectified_sgm_packed(main_img, nbr_img, params, num_steps: int,
                          p1: int, p2: int, cost_interp: bool = False,
                          nbr_pad: int = 0):
    """Warps + sweep + consistency for one pair.

    ``params`` packs the per-pair scalars into one f32[34] tensor:
    Hinv_main (9), Hinv_nbr (9), H_main (9), L_main (3), fB, off, disp0,
    dstep.
    """
    f32 = main_img.dtype
    params = params.to(f32)
    hinv_m = params[0:9].reshape(3, 3)
    hinv_n = params[9:18].reshape(3, 3)
    h_main = params[18:27].reshape(3, 3)
    l_main = params[27:30]
    fB, off, disp0, dstep = params[30], params[31], params[32], params[33]
    with span("sgm.rectify"):
        main_r = R.warp_homography(main_img, hinv_m)
        nbr_r = R.warp_homography(nbr_img, hinv_n,
                                  out_width=main_img.shape[1] + 2 * nbr_pad)
    shifts = iops.fma(dstep, torch.arange(num_steps, dtype=f32,
                                          device=main_img.device), disp0)
    return _rectified_sgm(main_r, nbr_r, hinv_n, h_main, l_main, fB, off,
                          disp0, dstep, shifts, p1, p2, cost_interp)


def _pair_params(rp, num_steps: int) -> np.ndarray:
    lo = float(rp.disp_lo)
    step = max((rp.disp_hi - lo) / max(num_steps - 1, 1), 1e-3)
    return np.concatenate([
        np.linalg.inv(rp.H_main).ravel(), np.linalg.inv(rp.H_nbr).ravel(),
        np.asarray(rp.H_main).ravel(), np.asarray(rp.L_main).ravel(),
        [rp.fB, rp.off, lo, step],
    ]).astype(np.float32)


def reconstruct_rectified(rp: R.RectifiedPair, main_img: torch.Tensor,
                          nbr_img: torch.Tensor,
                          opts: SGMOptions = SGMOptions()) -> torch.Tensor:
    """Bidirectional SGM through a precomputed rectification.

    Images are [H, W] intensities on the 0..255 scale in the original
    frames, on the device to run on; the depth map is in the main frame.
    """
    d = opts.num_steps
    params = torch.as_tensor(_pair_params(rp, d), device=main_img.device)
    return _rectified_sgm_packed(main_img, nbr_img, params, d, opts.penalty1,
                                 opts.penalty2, opts.cost_interp,
                                 nbr_pad=rp.nbr_pad)


def _average_depths(acc: torch.Tensor | None, d: torch.Tensor
                    ) -> torch.Tensor:
    """The reference's neighbor average (`app/smvsrecon.cc:347-384`): the
    mean where both maps see depth, else whichever does."""
    if acc is None:
        return d
    both = (acc > 0) & (d > 0)
    only2 = (acc == 0) & (d > 0)
    return torch.where(both, (acc + d) * 0.5, torch.where(only2, d, acc))


def reconstruct_auto_multi(cam_main, cams_nbr, main_img, nbr_imgs,
                           range_main: tuple[float, float], ranges_nbr,
                           opts: SGMOptions = SGMOptions(),
                           device: str | torch.device | None = None
                           ) -> torch.Tensor:
    """SGM of several neighbors, averaged (reference
    `app/smvsrecon.cc:347-384`), on ``device`` (the GPU unless ``"cpu"``):
    `reconstruct_auto` of each pair in turn.

    When every pair rectifies and the neighbor images share the main
    image's shape, all pairs rectify onto the widest pair's neighbor
    canvas, as the JAX package does to fuse them into one program. The
    pad enters the neighbor's homography and the sweep, so sharing it
    keeps the depth maps equal to the JAX package's.
    """
    dev = resolve_device(device)
    main_img = torch.as_tensor(main_img, device=dev)
    nbr_imgs = [torch.as_tensor(n, device=dev) for n in nbr_imgs]
    h, w = main_img.shape
    pad = None
    if all(tuple(n.shape) == (h, w) for n in nbr_imgs):
        with span("sgm.rectify"):
            rps = [R.rectify_pair(cam_main, c, w, h, range_main, rn)
                   for c, rn in zip(cams_nbr, ranges_nbr)]
        if all(rp.valid for rp in rps):
            pad = max(rp.nbr_pad for rp in rps)
    acc = None
    for cam_n, nbr, rn in zip(cams_nbr, nbr_imgs, ranges_nbr):
        acc = _average_depths(acc, reconstruct_auto(
            cam_main, cam_n, main_img, nbr, range_main, rn, opts, dev,
            nbr_pad=pad))
    return acc


def reconstruct_auto(cam_main, cam_nbr, main_img, nbr_img,
                     range_main: tuple[float, float],
                     range_nbr: tuple[float, float],
                     opts: SGMOptions = SGMOptions(),
                     device: str | torch.device | None = None,
                     nbr_pad: int | None = None) -> torch.Tensor:
    """Camera-level SGM entry (reference `SGMStereo::reconstruct`, :46-96).

    Runs on ``device`` (the GPU unless the caller passes ``"cpu"``): the
    rectified sweep when the pair geometry allows it, else the general
    warp (near-forward motion). ``nbr_pad`` fixes the rectified neighbor
    canvas's padding (default: the pair's own). The call is the span
    ``sgm.pair``.
    """
    with span("sgm.pair"):
        return _reconstruct_pair(cam_main, cam_nbr, main_img, nbr_img,
                                 range_main, range_nbr, opts,
                                 resolve_device(device), nbr_pad)


def _reconstruct_pair(cam_main, cam_nbr, main_img, nbr_img, range_main,
                      range_nbr, opts, dev, nbr_pad) -> torch.Tensor:
    """`reconstruct_auto`'s body on its resolved device."""
    main_img = torch.as_tensor(main_img, device=dev)
    nbr_img = torch.as_tensor(nbr_img, device=dev)
    h, w = main_img.shape
    with span("sgm.rectify"):
        rp = R.rectify_pair(cam_main, cam_nbr, w, h, range_main, range_nbr,
                            nbr_pad=nbr_pad)
    if rp.valid:
        return reconstruct_rectified(rp, main_img, nbr_img, opts)
    hn, wn = nbr_img.shape
    M_mn, t_mn = cam_main.fill_reprojection(cam_nbr, w, h, wn, hn)
    M_nm, t_nm = cam_nbr.fill_reprojection(cam_main, wn, hn, w, h)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return reconstruct(main_img, nbr_img, f32(M_mn), f32(t_mn), f32(M_nm),
                       f32(t_nm), range_main, range_nbr, opts)
