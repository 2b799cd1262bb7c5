"""Plain reference of the SGM depth initialization (rectified pairs).

A frozen copy of the port's plain path, kept with the benchmark so that a
later change to the program is held to it: the 9x7 census as one 63-bit
word, the per-plane Hamming cost volume over fractional x-shifts of the
rectified neighbor, the 8-path aggregation as the plain sweep (a loop over
the scan axis in int32; the program runs CUDA kernels there), sub-pixel
WTA, bidirectional consistency and un-rectify, and the average over
neighbors. The half-size rescales of the command line's input and SGM
scales are here too. Every stage runs in plain PyTorch on whatever device
its inputs live on.

Only the rectified path is kept: every pair of the configurations in this
benchmark rectifies, and `sgm_depth` raises on one that does not. The
float stages run in the dtype of the images given to `sgm_depth`
(float32, as the program runs them; bfloat16 for the control).

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmarks.reference.camera import Camera


def _edge_pad(x: torch.Tensor, dim: int, before: int, after: int
              ) -> torch.Tensor:
    """Edge-replicating pad of ``x`` along ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, idx)


def rescale_half_size(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample (mve::image::rescale_half_size) of [..., H, W];
    odd sizes keep the partial last row/column by edge-padding.

    The four samples are summed in order, ((a + b) + c) + d. XLA's CPU
    code sums the JAX version's mean the same way at most widths, but
    pairwise, (a + b) + (c + d), at power-of-two output widths (and some
    odd sizes); there about a fifth of the pixels differ by 1-2 ulp, and
    the census turns a few of those into other SGM costs
    (tests/test_torch_scene.py, tests/test_torch_general.py).
    """
    h, w = img.shape[-2], img.shape[-1]
    if h % 2:
        img = _edge_pad(img, img.ndim - 2, 0, 1)
    if w % 2:
        img = _edge_pad(img, img.ndim - 1, 0, 1)
    a = img[..., 0::2, 0::2]
    b = img[..., 0::2, 1::2]
    c = img[..., 1::2, 0::2]
    d = img[..., 1::2, 1::2]
    return (((a + b) + c) + d) / 4


def rescale_half_size_gaussian(img: torch.Tensor,
                               sigma: float = math.sqrt(3.0) / 2.0
                               ) -> torch.Tensor:
    """Half-size rescale of [..., H, W] with 4x4 Gaussian taps
    (mve::image::rescale_half_size_gaussian, used at reference
    `app/smvsrecon.cc:637`). Output pixel centers sit at input coords
    (2i + 0.5, 2j + 0.5); taps at squared distances {0.5, 2.5, 4.5}.

    Within an ulp of the JAX version, which XLA rounds through fused
    multiply-adds; the CLI stores the result as uint8.
    """
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = (h + 1) // 2, (w + 1) // 2
    w1 = math.exp(-0.5 / (2.0 * sigma**2))
    w2 = math.exp(-2.5 / (2.0 * sigma**2))
    w3 = math.exp(-4.5 / (2.0 * sigma**2))
    kernel = np.array([[w3, w2, w2, w3], [w2, w1, w1, w2],
                       [w2, w1, w1, w2], [w3, w2, w2, w3]])
    kernel /= kernel.sum()
    xp = _edge_pad(img, img.ndim - 2, 1, 2 + h % 2)
    xp = _edge_pad(xp, img.ndim - 1, 1, 2 + w % 2)
    out = torch.zeros((*img.shape[:-2], oh, ow), dtype=img.dtype,
                      device=img.device)
    for dy in range(4):
        for dx in range(4):
            sl = xp[..., dy : dy + 2 * oh : 2, dx : dx + 2 * ow : 2]
            out = out + float(kernel[dy, dx]) * sl
    return out


def _corners(x: torch.Tensor, y: torch.Tensor, w: int, h: int):
    """Clamped base corner (x0, y0) as int64 and the blend fractions."""
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = x - x0.to(x.dtype)
    fy = y - y0.to(y.dtype)
    return x0, y0, fx, fy


def pack_window4(img: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H, W, 4] with each pixel's 2x2 support (v00, v10, v01, v11).

    The rolls wrap, but wrapped entries sit at x=W-1 / y=H-1, which
    clamped sampling never addresses.
    """
    x1 = torch.roll(img, -1, dims=-1)
    y1 = torch.roll(img, -1, dims=-2)
    xy1 = torch.roll(x1, -1, dims=-2)
    return torch.stack([img, x1, y1, xy1], dim=-1)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, like a fused multiply-add.

    XLA's CPU compile fuses some of the JAX package's products and sums
    into FMAs (the SGM sweep's shift ramp and plane blend, the warps'
    bilinear blends), and a census flips a bit on a one-ulp difference,
    so the port rounds those the same way on every device: float64 holds
    the float32 product exactly.
    """
    if a.dtype != torch.float32:
        return a * b + c
    return (a.double() * b.double() + c.double()).to(torch.float32)


def bilinear_packed4_fma(img4: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                         ) -> torch.Tensor:
    """`bilinear_packed4` with each blend ``a * (1 - f) + b * f`` as XLA
    fuses it in a compiled warp: ``fma(b, f, a * (1 - f))``, the last one
    as ``fma(top, 1 - fy, bot * fy)``."""
    h, w = img4.shape[0], img4.shape[1]
    shape = x.shape
    x0, y0, fx, fy = _corners(x.reshape(-1), y.reshape(-1), w, h)
    rows = img4.reshape(h * w, 4)[y0 * w + x0]  # [M, 4]
    top = fma(rows[:, 1], fx, rows[:, 0] * (1 - fx))
    bot = fma(rows[:, 3], fx, rows[:, 2] * (1 - fx))
    return fma(top, 1 - fy, bot * fy).reshape(shape)


BIG = 1 << 24


def _min_plus(prev, cost, p1: int, p2a):
    """new = cost + min(prev, prev[d+-1] + P1, min(prev) + P2a) - min(prev)."""
    big = torch.full_like(prev[..., :1], BIG)
    up = torch.cat([prev[..., 1:], big], dim=-1)
    dn = torch.cat([big, prev[..., :-1]], dim=-1)
    min_prev = prev.amin(dim=-1, keepdim=True)
    upd = torch.minimum(torch.minimum(prev, torch.minimum(up, dn) + p1),
                        min_prev + p2a[..., None])
    return cost + upd - min_prev


def plain_paths(cost, inten, reverse: bool, shifts: tuple, p1: int,
                p2: int) -> torch.Tensor:
    """The plain sweep: the sum of the path costs of ``shifts`` in int32.
    cost [B, X, L, D] scanned along X, inten [B, X, L]."""
    B, X, L, D = cost.shape
    out = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
    inten = inten.to(torch.int32)
    order = range(X - 1, -1, -1) if reverse else range(X)
    prevs = [None] * len(shifts)
    prev_int = None
    p2min = p1 * 3 // 2
    for step, x in enumerate(order):
        c = cost[:, x].to(torch.int32)  # [B, L, D]
        it = inten[:, x]  # [B, L]
        for k, shift in enumerate(shifts):
            if step == 0:
                new = c
            else:
                prev = prevs[k]
                pi = prev_int
                if shift:
                    prev = torch.roll(prev, shift, dims=1)
                    pi = torch.roll(pi, shift, dims=1)
                    prev[:, 0 if shift > 0 else L - 1] = BIG
                p2a = torch.clamp(p2 // (torch.abs(it - pi) + 1), min=p2min)
                new = _min_plus(prev, c, p1, p2a)
            prevs[k] = new
            out[:, x] += new
        prev_int = it
    return out


def plain_fused_pass_batch(cost, inten, acc, reverse: bool, shifts: tuple,
                           p1: int, p2: int) -> torch.Tensor:
    """Plain version of `fused_pass_batch`: returns ``acc`` plus the paths
    in int32. cost/acc [B, X, L, D], inten [B, X, L]."""
    return acc.to(torch.int32) + plain_paths(cost, inten, reverse, shifts,
                                             p1, p2)


def plain_aggregate_batch(cost, intensity, p1: int, p2: int) -> torch.Tensor:
    """Plain version of `aggregate_batch`: the 8-path sum in int32."""
    inten = intensity.to(torch.int32)
    ct = cost.transpose(1, 2)  # [B, W, H, D]: horizontal sweeps scan x
    it = inten.transpose(1, 2)
    acc = torch.zeros(ct.shape, dtype=torch.int32, device=cost.device)
    acc = plain_fused_pass_batch(ct, it, acc, False, (0,), p1, p2)
    acc = plain_fused_pass_batch(ct, it, acc, True, (0,), p1, p2)
    acc = acc.transpose(1, 2)
    acc = plain_fused_pass_batch(cost, inten, acc, False, (0, 1, -1), p1, p2)
    return plain_fused_pass_batch(cost, inten, acc, True, (0, 1, -1), p1, p2)


@dataclasses.dataclass(frozen=True)
class RectifiedPair:
    """Host-side rectification data for one (main, neighbor) view pair.

    A pixel (x, y) is addressed at continuous coordinates (x+0.5, y+0.5).

    Attributes:
      H_main / H_nbr: 3x3 homographies from original pixel-center
        homogeneous coords to rectified pixel-center coords.
      fB: rectified focal length times signed baseline; a point at
        rectified depth Z has disparity ``fB / Z + off``.
      off: constant disparity offset.
      L_main: linear form; the main-camera z-depth of rectified pixel r at
        rectified depth Z is ``Z * (L_main @ (r_x, r_y, 1))``.
      disp_lo / disp_hi: disparity sweep bounds.
      nbr_pad: extra columns on each side of the rectified neighbor
        canvas; H_nbr/off/disp_* are in the widened canvas coordinates.
    """

    valid: bool
    width: int = 0
    height: int = 0
    H_main: np.ndarray | None = None
    H_nbr: np.ndarray | None = None
    fB: float = 0.0
    off: float = 0.0
    L_main: np.ndarray | None = None
    disp_lo: float = 0.0
    disp_hi: float = 0.0
    nbr_pad: int = 0


def _pixel_grid_form(row3: np.ndarray, width: int, height: int,
                     n: int = 5) -> np.ndarray:
    """Evaluate a linear form row3 . (x+0.5, y+0.5, 1) over an n x n grid."""
    xs = np.linspace(0.5, width - 0.5, n)
    ys = np.linspace(0.5, height - 0.5, n)
    gx, gy = np.meshgrid(xs, ys)
    return row3[0] * gx + row3[1] * gy + row3[2]


def rectify_pair(
    cam_main: Camera,
    cam_nbr: Camera,
    width: int,
    height: int,
    range_main: tuple[float, float],
    range_nbr: tuple[float, float],
    min_baseline: float = 1e-9,
    min_perp: float = 0.15,
    nbr_pad: int | None = None,
) -> RectifiedPair:
    """Rectifying transforms for a view pair, or ``valid=False`` for a
    degenerate (near-forward-motion) pair. ``range_*`` are (min, max)
    z-depth sweep ranges in each camera's frame."""
    invalid = RectifiedPair(valid=False)

    C1 = cam_main.cam_position()
    C2 = cam_nbr.cam_position()
    b = C2 - C1
    bn = np.linalg.norm(b)
    if bn < min_baseline:
        return invalid

    e1 = b / bn
    if np.dot(e1, cam_main.rot[0]) < 0:
        e1 = -e1
    z_ref = cam_main.viewing_direction()
    e3 = z_ref - np.dot(z_ref, e1) * e1
    n3 = np.linalg.norm(e3)
    if n3 < min_perp:
        return invalid
    e3 /= n3
    e2 = np.cross(e3, e1)
    R_r = np.stack([e1, e2, e3])  # world-to-rectified rotation

    f = cam_main.flen_pixels(width, height)
    K1_inv = cam_main.inverse_calibration(width, height)
    K2_inv = cam_nbr.inverse_calibration(width, height)

    A_main = R_r @ cam_main.rot.T @ K1_inv
    A_nbr = R_r @ cam_nbr.rot.T @ K2_inv

    g_main = _pixel_grid_form(A_main[2], width, height)
    g_nbr = _pixel_grid_form(A_nbr[2], width, height)
    if g_main.min() < 0.2 or g_nbr.min() < 0.2:
        return invalid

    def k_rect(A):
        c = A @ np.array([width / 2.0, height / 2.0, 1.0])
        cx = width / 2.0 - f * c[0] / c[2]
        cy = height / 2.0 - f * c[1] / c[2]
        return np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]]), cx, cy

    K_rm, cx_m, cy_m = k_rect(A_main)
    K_rn, cx_n, _ = k_rect(A_nbr)
    K_rn[1, 2] = K_rm[1, 2]

    H_main = K_rm @ A_main
    H_nbr = K_rn @ A_nbr

    corners = np.array([[0.5, 0.5, 1], [width - 0.5, 0.5, 1],
                        [0.5, height - 0.5, 1],
                        [width - 0.5, height - 0.5, 1]], dtype=np.float64)
    ym = (corners @ H_main.T)
    yn = (corners @ H_nbr.T)
    ym = ym[:, 1] / ym[:, 2]
    yn = yn[:, 1] / yn[:, 2]
    lo = max(ym.min(), yn.min(), 0.0)
    hi = min(ym.max(), yn.max(), float(height))
    if hi - lo < 0.25 * height:
        return invalid

    xn = corners @ H_nbr.T
    xn = xn[:, 0] / xn[:, 2]
    need = max(0.0, -xn.min(), xn.max() - width)
    q = 128 if width >= 768 else 32
    auto_pad = int(min(int(np.ceil(need / q)) * q, 3 * q))
    pad = auto_pad if nbr_pad is None else int(nbr_pad)
    if pad:
        H_nbr = H_nbr.copy()
        H_nbr[0, :] += pad * H_nbr[2, :]
        cx_n += pad

    B = float(np.dot(e1, b))
    fB = f * B
    off = float(cx_m - cx_n)

    z_bounds = []
    for (dmin, dmax), g in ((range_main, g_main), (range_nbr, g_nbr)):
        z_bounds.append(dmin * g.min())
        z_bounds.append(dmax * g.max())
    z_lo, z_hi = max(min(z_bounds), 1e-9), max(z_bounds)
    d_a, d_b = fB / z_lo, fB / z_hi
    disp_lo, disp_hi = min(d_a, d_b) + off, max(d_a, d_b) + off
    disp_lo = float(np.clip(disp_lo, -(width + pad), width + pad))
    disp_hi = float(np.clip(disp_hi, -(width + pad), width + pad))

    L_main = (cam_main.rot @ R_r.T @ np.linalg.inv(K_rm))[2]

    return RectifiedPair(
        valid=True, width=width, height=height,
        H_main=H_main, H_nbr=H_nbr, fB=fB, off=off, L_main=L_main,
        disp_lo=disp_lo, disp_hi=disp_hi, nbr_pad=pad,
    )


def warp_homography(img: torch.Tensor, H_inv: torch.Tensor,
                    out_width: int | None = None) -> torch.Tensor:
    """Resample ``img`` [H, W] under an output->input pixel homography.

    Output pixel (x, y) samples the input at ``H_inv @ (x+0.5, y+0.5, 1)``
    (bilinear, zero outside); ``out_width`` renders onto a wider canvas.
    Rounded as the JAX package's compiled warp: the homography's linear
    forms in plain float32, the bilinear blends as fused multiply-adds
    (`bilinear_packed4_fma`), so the census of a rectified image
    reads the same bits.
    """
    h, w = img.shape
    ow = w if out_width is None else out_width
    ys = torch.arange(h, device=img.device).to(img.dtype)[:, None]
    xs = torch.arange(ow, device=img.device).to(img.dtype)[None, :]
    u = xs + 0.5
    v = ys + 0.5
    Hc = H_inv.to(img.dtype)
    px = Hc[0, 0] * u + Hc[0, 1] * v + Hc[0, 2]
    py = Hc[1, 0] * u + Hc[1, 1] * v + Hc[1, 2]
    pz = Hc[2, 0] * u + Hc[2, 1] * v + Hc[2, 2]
    px = px / pz - 0.5
    py = py / pz - 0.5
    ok = (pz > 0) & (px >= 0) & (py >= 0) & (px <= w - 1) & (py <= h - 1)
    return torch.where(ok, bilinear_packed4_fma(pack_window4(img),
                                                     px, py), 0.0)


INVALID_COST = 255  # reference fills missing warps with 255 (:216-221)


_PLANE_CHUNK = 8


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
    if out is None:
        out = torch.empty((h, w, D), dtype=torch.int16, device=nbr_img.device)
    for c0 in range(0, D, _PLANE_CHUNK):
        c1 = min(D, c0 + _PLANE_CHUNK)
        t0 = torch.stack([pimg[:, s : s + w] for s in starts[c0:c1]])
        t1 = torch.stack([pimg[:, s - 1 : s - 1 + w] for s in starts[c0:c1]])
        a = frac[c0:c1, None, None]
        warped = torch.where((t0 != 0) & (t1 != 0),
                             fma(1 - a, t0, a * t1), 0.0)
        cost = _hamming(m_census, census_transform(warped))
        cost = torch.where(warped != 0, cost, INVALID_COST)
        out[..., c0:c1] = cost.permute(1, 2, 0).to(torch.int16)
    return out


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
    cost_fn = _disparity_cost_interp if cost_interp else _disparity_cost
    cost_fn(m_c, nbr_r, shifts, out=vol[0, :, :w])
    cost_fn(n_c, main_r, -shifts, out=vol[1])
    im = torch.nn.functional.pad(main_r, (0, wn - w))
    inten = torch.stack([im, nbr_r]).to(torch.int32)
    agg2 = plain_aggregate_batch(vol, inten, p1, p2).to(torch.int16)
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
    main_r = warp_homography(main_img, hinv_m)
    nbr_r = warp_homography(nbr_img, hinv_n,
                              out_width=main_img.shape[1] + 2 * nbr_pad)
    shifts = fma(dstep, torch.arange(num_steps, dtype=f32,
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


def _average_depths(acc: torch.Tensor | None, d: torch.Tensor
                    ) -> torch.Tensor:
    """The reference's neighbor average (`app/smvsrecon.cc:347-384`): the
    mean where both maps see depth, else whichever does."""
    if acc is None:
        return d
    both = (acc > 0) & (d > 0)
    only2 = (acc == 0) & (d > 0)
    return torch.where(both, (acc + d) * 0.5, torch.where(only2, d, acc))


def sgm_depth(cam_main: Camera, cams_nbr: list, main_img: torch.Tensor,
              nbr_imgs: list, range_main: tuple, ranges_nbr: list,
              num_steps: int = 128, penalty1: int = 6, penalty2: int = 96,
              dtype=torch.float32) -> torch.Tensor:
    """SGM z-depth of the main view from each neighbor, averaged.

    Images are [H, W] intensities on the 0..255 scale; every pair is
    rectified onto the widest pair's neighbor canvas where the neighbor
    images share the main image's shape (each pair's own canvas
    otherwise), as the program does. ``dtype`` is the float stages'
    precision.
    """
    main_img = main_img.to(dtype)
    nbr_imgs = [n.to(dtype) for n in nbr_imgs]
    h, w = main_img.shape
    rps = [rectify_pair(cam_main, c, w, h, range_main, rn)
           for c, rn in zip(cams_nbr, ranges_nbr)]
    if not all(rp.valid for rp in rps):
        raise NotImplementedError("the plain reference takes rectified "
                                  "pairs only")
    pad = None
    if all(tuple(n.shape) == (h, w) for n in nbr_imgs):
        pad = max(rp.nbr_pad for rp in rps)
    acc = None
    for cam_n, nbr, rn in zip(cams_nbr, nbr_imgs, ranges_nbr):
        rp = rectify_pair(cam_main, cam_n, w, h, range_main, rn, nbr_pad=pad)
        if not rp.valid:
            raise NotImplementedError("the plain reference takes rectified "
                                      "pairs only")
        params = torch.as_tensor(_pair_params(rp, num_steps),
                                 device=main_img.device)
        d = _rectified_sgm_packed(main_img, nbr, params, num_steps, penalty1,
                                  penalty2, nbr_pad=rp.nbr_pad)
        acc = _average_depths(acc, d.float())
    return acc
