"""Plain reference of the command line's per-view set-up for a scan.

Frozen copies of what `smvsrecon` works out before a view's SGM: the
automatic input scale, the half-size input images stored as 8 bits, the
shared padded canvas and its camera, the bundle-based neighbor selection
and the SGM depth range from the bundle's features. The reference works
these out again from the benchmark's photos, cameras and features, so it
takes nothing that the program derived.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference import sgm_plain
from benchmarks.reference.camera import Camera


def input_scale(width: int, height: int, max_pixels: int) -> int:
    """`-s` automatic: halvings until the mean view holds <= max_pixels."""
    avg = float(width * height)
    return int(np.ceil(np.log2(avg / max_pixels) / 2)) if avg > max_pixels \
        else 0


def working_dims(width: int, height: int, scale: int) -> tuple:
    """(height, width) after ``scale`` halvings."""
    h, w = height, width
    for _ in range(scale):
        h, w = (h + 1) // 2, (w + 1) // 2
    return h, w


def padded_dims(h: int, w: int, quantum: int) -> tuple:
    return -(-h // quantum) * quantum, -(-w // quantum) * quantum


def working_image(photo: torch.Tensor, scale: int) -> torch.Tensor:
    """The input image at the working scale, float32 in [0, 1]: the photo
    over 255, ``scale`` Gaussian half-size rescales, stored as 8 bits
    (truncated), read back over 255 in float64."""
    if scale == 0:
        return (photo.to(torch.float64) / 255.0).to(torch.float32)
    x = photo.to(torch.float32) / 255.0
    for _ in range(scale):
        x = sgm_plain.rescale_half_size_gaussian(x)
    u8 = (x * 255).clamp(0, 255).to(torch.uint8)
    return (u8.to(torch.float64) / 255.0).to(torch.float32)


def padded(img: torch.Tensor, cam: Camera, canvas: tuple):
    """Edge-pad a working image to the canvas (height, width), with the
    camera whose pixel rays are the original's."""
    h, w = img.shape
    ph, pw = canvas
    if (ph, pw) == (h, w):
        return img, cam
    img = torch.nn.functional.pad(img[None, None], (0, pw - w, 0, ph - h),
                                  mode="replicate")[0, 0]
    return img, cam.resized_canvas(w, h, pw, ph)


def feature_depths(features: np.ndarray, cam: Camera, width: int,
                   height: int) -> np.ndarray:
    """Z-depths of the features (all seen by the view) that project inside
    the image."""
    p = cam.world_to_cam(features)
    p = p[p[:, 2] > 0]
    uv = cam.project(p, width, height)
    ok = (np.floor(uv[:, 0]) >= 0) & (np.floor(uv[:, 0]) < width) & \
        (np.floor(uv[:, 1]) >= 0) & (np.floor(uv[:, 1]) < height)
    return p[ok, 2]


def depth_range(features, cam, width, height) -> tuple:
    return sgm_plain.depth_range_from_features(
        feature_depths(features, cam, width, height))


def neighbors(cams: list, sizes: list, features: np.ndarray, view: int,
              num: int) -> list:
    """Bundle-based selection for a bundle whose features every view sees:
    among the 50 nearest cameras, those sharing more than 10 features at a
    pixel-footprint ratio above 0.6, most first, at most ``num``."""
    main = cams[view]
    pos0 = main.cam_position()
    order = sorted((float(np.linalg.norm(pos0 - c.cam_position())), i)
                   for i, c in enumerate(cams) if i != view)
    w, h = sizes[view]
    foot0 = main.world_to_cam(features)[:, 2] * \
        main.inverse_calibration(w, h)[0, 0]
    scored = []
    for _, i in order[:50]:
        wi, hi = sizes[i]
        foot = cams[i].world_to_cam(features)[:, 2] * \
            cams[i].inverse_calibration(wi, hi)[0, 0]
        lo, up = np.minimum(foot, foot0), np.maximum(foot, foot0)
        ratio = np.where(up != 0, lo / np.where(up == 0, 1, up), 0)
        scored.append((int(np.sum(ratio > 0.6)), i))
    scored.sort(key=lambda t: -t[0])
    return [i for n, i in scored if n > 10][:num]


def sgm_view(scan: dict, opts: dict, view: int, dtype=torch.float32
             ) -> torch.Tensor:
    """The SGM z-depth of one view of a scan at the SGM scale on the
    padded canvas, from its first two neighbors, as `smvsrecon` makes it.

    ``scan``: the benchmark's ``cameras`` (reference `Camera`), ``photos``
    (uint8 [N, H, W]), ``features`` and ``size``; ``opts``: the
    configuration's smvsrecon options. ``dtype``: the float stages'
    precision (the control's is lower).
    """
    width, height = scan["size"]
    cams = scan["cameras"]
    scale = opts["scale"] if opts["scale"] >= 0 else input_scale(
        width, height, opts["max_pixels"])
    h, w = working_dims(width, height, scale)
    canvas = padded_dims(h, w, opts["pad_bucket"])
    sizes = [(width, height)] * len(cams)
    nbrs = neighbors(cams, sizes, scan["features"], view, opts["neighbors"])

    def at_sgm_scale(i):
        img, cam = padded(working_image(scan["photos"][i], scale), cams[i],
                          canvas)
        x = img * 255.0
        for _ in range(opts["sgm_scale"]):
            x = sgm_plain.rescale_half_size(x)
        return x, cam

    main, cam_m = at_sgm_scale(view)
    sh, sw = main.shape
    others = [at_sgm_scale(n) for n in nbrs[:2]]
    feats = scan["features"]
    return sgm_plain.sgm_depth(
        cam_m, [c for _, c in others], main, [x for x, _ in others],
        depth_range(feats, cam_m, sw, sh),
        [depth_range(feats, c, x.shape[1], x.shape[0]) for x, c in others],
        num_steps=opts["sgm_planes"], dtype=dtype)



def sgm_init(sgm_depth, dims: tuple, canvas: tuple, sgm_scale: int
             ) -> np.ndarray:
    """`cli.main`'s ``prepare_sgm`` for a fresh map: the SGM depth at the
    SGM scale brought to the canvas (height, width) that it covers by
    nearest upsampling, zero padded to the canvas; ``dims`` is the working
    image's (height, width)."""
    (oh, ow), (h, w) = dims, canvas
    s = 2 ** sgm_scale
    d = np.asarray(torch.as_tensor(sgm_depth).cpu(), np.float32)
    sh, sw = d.shape
    covers = abs(sh * s - h) <= s and (h, w) != (oh, ow)
    th, tw = (h, w) if covers or (h, w) == (oh, ow) else (oh, ow)
    if (sh, sw) != (th, tw):
        yy = (np.arange(th) * sh / th).astype(int)
        xx = (np.arange(tw) * sw / tw).astype(int)
        d = d[yy][:, xx]
    if d.shape != (h, w):
        d = np.pad(d, ((0, h - d.shape[0]), (0, w - d.shape[1])))
    return d
