"""Semi-global matching depth initialization, rectified path (port of
`smvs_tpu/sgm/stereo.py`).

- 9x7 census transform held as one int64 word of 63 bits (the JAX
  package packs the same bits into two uint32 words);
- per-plane census Hamming cost over fractional x-shifts of the
  rectified neighbor, built plane group by plane group into an int16
  volume;
- 8-path aggregation of both SGM directions in one `cuda_agg.aggregate_batch`
  call (the CUDA kernel on the card, its plain twin on the CPU);
- sub-pixel WTA, bidirectional consistency and un-rectify.

Pairs that do not rectify (near-forward motion) take the general-warp
path in the JAX package; that path is not ported yet and raises here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.sgm import cuda_agg
from smvs_tpu_torch.sgm import rectify as R

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
    # Cost-space interpolation of the rectified sweep; not ported yet.
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


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, like a fused multiply-add.

    XLA fuses the sweep's shift ramp and plane blend into FMAs, and the
    census of a blended plane flips a bit on a one-ulp difference, so the
    port rounds these two the same way on every device: float64 holds the
    float32 product exactly.
    """
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).to(torch.float32)


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
    if out is None:
        out = torch.empty((h, w, D), dtype=torch.int16, device=nbr_img.device)
    for c0 in range(0, D, _PLANE_CHUNK):
        c1 = min(D, c0 + _PLANE_CHUNK)
        t0 = torch.stack([pimg[:, s : s + w] for s in starts[c0:c1]])
        t1 = torch.stack([pimg[:, s - 1 : s - 1 + w] for s in starts[c0:c1]])
        a = frac[c0:c1, None, None]
        warped = torch.where((t0 != 0) & (t1 != 0), _fma(1 - a, t0, a * t1),
                             0.0)
        cost = _hamming(m_census, census_transform(warped))
        cost = torch.where(warped != 0, cost, INVALID_COST)
        out[..., c0:c1] = cost.permute(1, 2, 0).to(torch.int16)
    return out


def aggregate(cost: torch.Tensor, intensity: torch.Tensor, p1: int, p2: int
              ) -> torch.Tensor:
    """8-path SGM aggregation of one volume (reference `aggregate_sgm_costs`,
    :429-667), the plain twin of the CUDA kernel.

    cost: [H, W, D] integer; intensity: [H, W]. Returns the int32 sum.
    """
    return cuda_agg.plain_aggregate_batch(cost[None], intensity[None],
                                          p1, p2)[0]


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
                   disp0, dstep, shifts, p1: int, p2: int) -> torch.Tensor:
    """Bidirectional SGM in the rectified frame -> main-view z-depth.

    main_r [H, W] / nbr_r [H, W + 2*nbr_pad]: rectified intensities (0..255,
    0 = outside the original image). H_main maps original main pixel
    centers to rectified ones; hinv_nbr maps rectified-neighbor coords back
    to the original neighbor frame (for the 3% border cut); L_main turns
    rectified depth into main z-depth.
    """
    h, w = main_r.shape
    wn = nbr_r.shape[1]
    f32 = main_r.dtype
    D = shifts.shape[0]
    dev = main_r.device

    m_c = census_transform(main_r)
    n_c = census_transform(nbr_r)

    # Both directions ride one batched aggregation; the main problem is
    # padded to the widened neighbor canvas with INVALID columns, which
    # leave the real columns' path costs unchanged (a uniform previous
    # line restarts the recurrence).
    vol = torch.full((2, h, wn, D), INVALID_COST, dtype=torch.int16,
                     device=dev)
    _disparity_cost(m_c, nbr_r, shifts, out=vol[0, :, :w])
    _disparity_cost(n_c, main_r, -shifts, out=vol[1])
    im = torch.nn.functional.pad(main_r, (0, wn - w))
    inten = torch.stack([im, nbr_r]).to(torch.int32)
    agg2 = cuda_agg.aggregate_batch(vol, inten, p1, p2)
    disp_m, ok_m = _wta_subpixel(agg2[0, :, :w], vol[0, :, :w], main_r,
                                 disp0, dstep)
    disp_n, ok_n = _wta_subpixel(agg2[1], vol[1], nbr_r, disp0, dstep)
    del agg2, vol

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
                          p1: int, p2: int, nbr_pad: int = 0):
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
    main_r = R.warp_homography(main_img, hinv_m)
    nbr_r = R.warp_homography(nbr_img, hinv_n,
                              out_width=main_img.shape[1] + 2 * nbr_pad)
    shifts = _fma(dstep, torch.arange(num_steps, dtype=f32,
                                      device=main_img.device), disp0)
    return _rectified_sgm(main_r, nbr_r, hinv_n, h_main, l_main, fB, off,
                          disp0, dstep, shifts, p1, p2)


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
    if opts.cost_interp:
        raise NotImplementedError(
            "SGMOptions.cost_interp is not ported yet (ROADMAP.md queue 1)")
    d = opts.num_steps
    params = torch.as_tensor(_pair_params(rp, d), device=main_img.device)
    return _rectified_sgm_packed(main_img, nbr_img, params, d, opts.penalty1,
                                 opts.penalty2, nbr_pad=rp.nbr_pad)


def reconstruct_auto(cam_main, cam_nbr, main_img, nbr_img,
                     range_main: tuple[float, float],
                     range_nbr: tuple[float, float],
                     opts: SGMOptions = SGMOptions(),
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """Camera-level SGM entry (reference `SGMStereo::reconstruct`, :46-96).

    Runs the rectified sweep on ``device`` (the GPU unless the caller
    passes ``"cpu"``). A pair that does not rectify raises: its
    general-warp path is queued in ROADMAP.md, not ported.
    """
    dev = resolve_device(device)
    main_img = torch.as_tensor(main_img, device=dev)
    nbr_img = torch.as_tensor(nbr_img, device=dev)
    h, w = main_img.shape
    rp = R.rectify_pair(cam_main, cam_nbr, w, h, range_main, range_nbr)
    if not rp.valid:
        raise NotImplementedError(
            "this view pair does not rectify; the general-warp SGM path it "
            "needs is not ported yet (ROADMAP.md queue 1)")
    return reconstruct_rectified(rp, main_img, nbr_img, opts)
