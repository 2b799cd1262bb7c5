"""The benchmark's inputs: synthetic scenes rendered on the device from a seed.

A frozen copy of the scene generators that the port's drivers use, so that
a change to the program cannot change what it is measured on. Every scene
is a textured world plane, so the true depth of every pixel is known in
closed form (`plane_depth`, float64). The texture noise is drawn from the
configuration's own texture seeds, not from a run's seed: the solver's
work on a view follows its texture (its Newton steps and PCG iterations
differ up to twofold from one texture to another), so every run renders
the same scenes and does the same work, and a run's seed orders and
samples them (`drivers`).

Two generators, chosen by a configuration's ``scene.generator``:

- ``two_view_noise``: the pair of the port's `bench_main.run_once`: view
  0 a smoothed uniform-noise texture, view 1 rotated and shifted by the
  baseline, its image view 0's texture warped through the slanted plane
  ``5 + s * x + s * y`` (x, y its pixel indices; s scaled by the size).
- ``grid_plane``: a scan of views on a camera grid over the plane of
  `make_plane_scene`, its analytic texture plus a seeded noise field on
  the plane, rendered at the photo size and stored as 8-bit photos, as a
  camera writes them. A sparse bundle of features on the plane, seen by
  every view, stands in for structure from motion.

Nothing here imports the program or writes to disk.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks import check
from benchmarks.reference.camera import Camera

F64 = torch.float64


def generator(seed: int, device: torch.device) -> torch.Generator:
    """The random stream of a run: one generator on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """Bilinear sample ``img[y, x]`` with border clamp (MVE linear_at)."""
    h, w = img.shape
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0 = x.floor().long().clamp(0, w - 2)
    y0 = y.floor().long().clamp(0, h - 2)
    fx, fy = x - x0, y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy
            + img[y0 + 1, x0 + 1] * fx * fy)


def _smooth_noise(gen, shape, lo, hi, sigma, device) -> torch.Tensor:
    """Uniform noise in [lo, hi) blurred by a 9-tap Gaussian of ``sigma``
    along each axis, zero beyond the border (numpy's ``convolve(..,
    "same")``)."""
    tex = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=F64,
                                      device=device)
    k = torch.exp(-0.5 * (torch.arange(-4, 5, dtype=F64, device=device)
                          / sigma) ** 2)
    k = (k / k.sum()).view(1, 1, 9)
    rows = torch.nn.functional.conv1d(tex.T[:, None], k, padding=4)[:, 0].T
    return torch.nn.functional.conv1d(rows[:, None], k, padding=4)[:, 0]


def two_view_pairs(scene: dict, device: torch.device) -> list:
    """The pairs of the ``two_view_noise`` scene, one for each of
    ``scene["texture_seeds"]``.

    Each pair is a dict: ``cameras`` (view 0, view 1), ``images`` (float32
    [dim, dim] in [0, 1], view 0 then view 1), ``depth`` (float64 [dim,
    dim], the true z-depth of view 1, the main view).
    """
    dim = int(scene["dim"])
    rot1 = np.asarray(scene["rotation"], np.float64)
    cam0 = Camera(flen=1.0, rot=np.eye(3), trans=np.zeros(3))
    cam1 = Camera(flen=1.0, rot=rot1,
                  trans=np.array([scene["baseline"], 0.0, 0.0]))
    xs = torch.arange(dim, dtype=F64, device=device)[None, :].expand(dim, dim)
    ys = torch.arange(dim, dtype=F64, device=device)[:, None].expand(dim, dim)
    depth1 = two_view_depth(scene, device)
    M, t = (torch.as_tensor(a, dtype=F64, device=device)
            for a in cam1.fill_reprojection(cam0, dim, dim, dim, dim))
    u, v = xs + 0.5, ys + 0.5
    proj = depth1[..., None] * (M[:, 0] * u[..., None] + M[:, 1] * v[..., None]
                                + M[:, 2]) + t
    px = proj[..., 0] / proj[..., 2] - 0.5
    py = proj[..., 1] / proj[..., 2] - 0.5
    valid = (px > 0.0) & (px < dim) & (py > 0.0) & (py < dim)
    lo, hi = scene["noise_range"]
    pairs = []
    for tseed in scene["texture_seeds"]:
        tex = _smooth_noise(generator(tseed, device), (dim, dim), lo, hi,
                            scene["noise_sigma"], device)
        image0 = (tex / 255.0).float()
        image1 = torch.where(valid, _bilinear(image0.double(), px, py),
                             scene["fill"] / 255.0).float()
        pairs.append({"cameras": (cam0, cam1), "images": (image0, image1),
                      "depth": depth1})
    return pairs


def two_view_depth(scene: dict, device: torch.device, tf32: bool = False
                   ) -> torch.Tensor:
    """The main view's true depth ``z0 + s x + s y`` as one product of the
    pixel's (x, y, 1) with (s, s, z0): float64, or with ``tf32`` float32
    with the operands rounded to TF32 (the control)."""
    dim = int(scene["dim"])
    z0, sx, sy = scene["plane"]
    scale = float(scene["plane_ref_dim"]) / dim
    dtype = torch.float32 if tf32 else F64
    rnd = check.tf32 if tf32 else (lambda x: x)
    idx = torch.arange(dim, dtype=dtype, device=device)
    pix = torch.stack(torch.broadcast_tensors(
        idx[None, :], idx[:, None], torch.ones((), dtype=dtype,
                                               device=device)), dim=-1)
    coef = torch.tensor([sx * scale, sy * scale, z0], dtype=dtype,
                        device=device)
    return rnd(pix) @ rnd(coef)


def _plane(scene: dict):
    nx, ny, d = scene["plane"]
    nrm = np.array([nx, ny, 1.0])
    return nrm / np.linalg.norm(nrm), float(d)


def plane_depth(scene: dict, cam: Camera, width: int, height: int,
                device: torch.device, tf32: bool = False) -> torch.Tensor:
    """True z-depth [height, width] of the plane in ``cam``, by the ray of
    each pixel center, in float64; with ``tf32``, in float32 with the
    operands of its products rounded to TF32 (the control)."""
    return _rays(scene, cam, width, height, device,
                 torch.float32 if tf32 else F64, tf32)[0]


def _rays(scene, cam, width, height, device, dtype, tf32=False):
    """(z-depth, world points [H, W, 3]) of each pixel's ray on the plane;
    ``tf32`` rounds the products' operands to TF32."""
    rnd = check.tf32 if tf32 else (lambda x: x)
    nrm, d = _plane(scene)
    inv = torch.as_tensor(cam.inverse_calibration(width, height), dtype=dtype,
                          device=device)
    xs = torch.arange(width, dtype=dtype, device=device)[None, :] + 0.5
    ys = torch.arange(height, dtype=dtype, device=device)[:, None] + 0.5
    dir_cam = torch.stack(torch.broadcast_tensors(
        inv[0, 0] * xs + inv[0, 2], inv[1, 1] * ys + inv[1, 2],
        torch.ones((), dtype=dtype, device=device)), dim=-1)
    rot = torch.as_tensor(cam.rot, dtype=dtype, device=device)
    dir_world = rnd(dir_cam) @ rnd(rot)  # R^T d
    C = torch.as_tensor(cam.cam_position(), dtype=dtype, device=device)
    n = torch.as_tensor(nrm, dtype=dtype, device=device)
    s = (d - rnd(n) @ rnd(C)) / (rnd(dir_world) @ rnd(n))
    return s, C + s[..., None] * dir_world


def grid_cameras(scene: dict) -> list:
    """The scan's cameras: a grid of ``cols`` columns, yawed and pitched
    toward its middle (`make_dtu_scene` of the JAX repository's DTU-scale
    benchmark)."""
    n, cols = int(scene["views"]), int(scene["cols"])
    rows = -(-n // cols)
    (step_x, step_y), (yaw_k, pitch_k) = scene["grid_step"], scene["grid_turn"]
    cams = []
    for i in range(n):
        gx = i % cols - (cols - 1) / 2
        gy = i // cols - (rows - 1) / 2
        cy, sy = np.cos(yaw_k * gx), np.sin(yaw_k * gx)
        cp, sp = np.cos(pitch_k * gy), np.sin(pitch_k * gy)
        rot = (np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
               @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
        pos = np.array([step_x * gx, step_y * gy, 0.0])
        cams.append(Camera(flen=1.0, rot=rot, trans=-rot @ pos))
    return cams


def _texture(scene: dict, field: torch.Tensor, P: torch.Tensor
             ) -> torch.Tensor:
    """The plane's texture at world points P [..., 3]: `make_plane_scene`'s
    sines plus the seeded noise field, sampled bilinearly on the plane's
    (x, y)."""
    x, y = P[..., 0], P[..., 1]
    base = (0.55 + 0.18 * torch.sin(2.1 * x) * torch.sin(1.7 * y)
            + 0.12 * torch.sin(5.3 * x + 1.0) * torch.cos(4.1 * y)
            + 0.08 * torch.cos(9.7 * x - 2.0) * torch.sin(8.3 * y + 0.7))
    (x0, y0), cell = scene["noise_origin"], float(scene["noise_cell"])
    return base + scene["noise_amp"] * _bilinear(field, (x - x0) / cell,
                                                 (y - y0) / cell)


def grid_scan(scene: dict, device: torch.device) -> dict:
    """The ``grid_plane`` scan (noise and features from
    ``scene["texture_seed"]``): ``cameras``, ``photos`` (uint8 [N, H, W]
    on the device, the texture times 255 truncated, as an 8-bit photo
    stores it), ``features`` (float64 [F, 3] world points of the sparse
    bundle, each seen by every view) and the photo ``size`` (W, H)."""
    width, height = (int(v) for v in scene["photo_size"])
    cams = grid_cameras(scene)
    gen = generator(scene["texture_seed"], device)
    field = 2.0 * torch.rand(tuple(scene["noise_shape"]), generator=gen,
                             dtype=F64, device=device) - 1.0
    photos = torch.empty((len(cams), height, width), dtype=torch.uint8,
                         device=device)
    for i, cam in enumerate(cams):
        _, P = _rays(scene, cam, width, height, device, F64)
        photos[i] = (_texture(scene, field, P) * 255.0).clamp(0, 255).to(
            torch.uint8)
    # Features: pixels of the last view, back-projected onto the plane
    # (`save_as_mve_scene`).
    rng = np.random.default_rng(int(scene["texture_seed"]))
    m = int(scene["features"])
    px = rng.integers(5, width - 5, size=m)
    py = rng.integers(5, height - 5, size=m)
    _, P = _rays(scene, cams[-1], width, height, torch.device("cpu"), F64)
    features = P[torch.as_tensor(py), torch.as_tensor(px)].numpy()
    return {"cameras": cams, "photos": photos, "features": features,
            "size": (width, height)}
