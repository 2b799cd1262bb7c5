"""smvsrecon-compatible command line driver (port of `smvs_tpu/cli.py`,
reference `app/smvsrecon.cc`).

Loads an MVE scene, selects neighbors per view, initializes each view
from SGM of up to two neighbors (averaged) or, with ``--no-sgm``, from the
bundle's feature splats, runs the depth optimizer per view on the card
(base mode, or shading-aware with ``-S``; every node active with
``--full-opt``), checkpoints each stage as `smvs-*` embeddings
(`smvs-B<scale>`, or `smvs-S<scale>` under ``-S``), and fuses all depth
maps on the host into a point-cloud PLY, or with ``-m`` a triangle mesh
(`smvs-m-B<scale>.ply`; greedy simplified per view with ``-y``).

Flag names and defaults mirror the JAX package's CLI (and the reference,
`app/smvsrecon.cc:85-140`), with ``--device`` in place of ``--platform``:
the GPU unless ``--device cpu`` is given. Color input images are read as
the JAX CLI reads them: the optimizer works on their luminance, the
shading image and the fused colors come from the RGB image, and the SGM
init takes gray views only, so a color scene needs ``--no-sgm`` (it
raises NotImplementedError otherwise, where the JAX CLI fails in its
SGM). ``-d`` above 1 writes the optimizer's debug images as embeddings
of each view and runs every view alone (no batching), each stage
synchronized for its time.

Views are optimized in groups, as the JAX CLI groups them: buckets keyed
by the padded working dims and the neighbor count, split into groups of
at most ``--batch-views`` views and ``BATCH_MP`` working megapixels in
all; a group of two or more views runs through
`pipeline.batch.optimize_view_batch` (one batched Newton loop and PCG),
a group of one through `optimize_view`.

Usage: python -m smvs_tpu_torch.cli [OPTS] SCENE_DIR
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from smvs_tpu_torch.core import scene as sc
from smvs_tpu_torch.core.camera import depth_mve_to_z, depth_z_to_mve
from smvs_tpu_torch.device import resolve_device
from smvs_tpu_torch.image import ops as iops
from smvs_tpu_torch.mesh import pointcloud as pc
from smvs_tpu_torch.mesh.ply import save_ply
from smvs_tpu_torch.pipeline import batch as VB
from smvs_tpu_torch.pipeline import optimizer as O
from smvs_tpu_torch.pipeline import view_selection as vs
from smvs_tpu_torch.pipeline.views import make_view
from smvs_tpu_torch.sgm import stereo as sgm
from smvs_tpu_torch.utils.timing import StageTimer

# Working megapixels of one batched group at most: the default of the JAX
# CLI's SMVS_BATCH_MP, so that both CLIs form the same groups.
BATCH_MP = 3.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smvsrecon",
        description="Shading aware Multi-View Stereo (PyTorch/CUDA port)")
    p.add_argument("scene", help="MVE scene directory")
    p.add_argument("-a", "--alpha", type=float, default=1.0,
                   help="Regularization parameter [1]")
    p.add_argument("-s", "--scale", type=int, default=-1,
                   help="Scale of input images [auto to <=1.7MP]")
    p.add_argument("-i", "--image", default="undistorted",
                   help="Image embedding [undistorted]")
    p.add_argument("-n", "--neighbors", type=int, default=6)
    p.add_argument("-o", "--output-scale", type=int, default=2)
    p.add_argument("-l", "--list-view", default="",
                   help="view IDs, e.g. \"0-10\" or \"1,3,5\"")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="accepted for smvsrecon compatibility; views run "
                        "one after another on the device")
    p.add_argument("-d", "--debug-lvl", type=int, default=0)
    p.add_argument("-r", "--recon-only", action="store_true")
    p.add_argument("-M", "--max-pixels", type=int, default=1700000)
    p.add_argument("-S", "--shading", action="store_true")
    p.add_argument("-R", "--regularize-lighting", type=float, default=0.0)
    p.add_argument("-g", "--gamma-srgb", action="store_true",
                   help="sRGB-decode the shading image (read by -S only)")
    p.add_argument("-m", "--mesh", action="store_true",
                   help="triangle mesh instead of point cloud")
    p.add_argument("-y", "--simplify", action="store_true",
                   help="greedy simplified mesh per view (read by -m only)")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--no-cut", action="store_true")
    p.add_argument("--aabb", default="")
    p.add_argument("--min-neighbors", type=int, default=3)
    p.add_argument("--no-sgm", action="store_true")
    p.add_argument("--force-sgm", action="store_true")
    p.add_argument("--sgm-scale", type=int, default=1)
    p.add_argument("--sgm-range", default="",
                   help="depth sweep range \"min,max\"")
    p.add_argument("--full-opt", action="store_true")
    p.add_argument("--clean", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; \"cpu\" to run on "
                        "the CPU)")
    p.add_argument("--batch-views", type=int, default=4,
                   help="optimize up to N views of one shape together "
                        "in one batched Newton loop (1 = one after "
                        "another)")
    p.add_argument("--pad-bucket", type=int, default=32,
                   help="pad working images (edge mode, exact camera "
                        "adjustment) up to multiples of N pixels so all "
                        "views share one canvas (1 = off)")
    return p


def parse_view_list(spec: str, n: int) -> list[int]:
    if not spec:
        return list(range(n))
    out: list[int] = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    conf = build_parser().parse_args(argv)
    dev = resolve_device(conf.device)

    scene = sc.Scene.load(conf.scene)
    views = scene.views
    if not views:
        print(f"error: no views in {conf.scene}", file=sys.stderr)
        return 1
    bundle = scene.bundle
    use_sgm = not conf.no_sgm
    sgm_range = None
    if conf.sgm_range:
        lo, hi = conf.sgm_range.split(",")
        sgm_range = (float(lo), float(hi))
    if bundle is None:
        print("Cannot load bundle file, forcing SGM.")
        use_sgm = True
        if sgm_range is None:
            print("Error: no bundle and no --sgm-range given.",
                  file=sys.stderr)
            return 1

    # ---- legacy-embedding migration (reference `app/smvsrecon.cc:429-452`):
    # drop pre-release debug embeddings and rename `sgm-depth` -> `smvs-sgm`.
    for v in views:
        for legacy in ("lighting-shaded", "lighting-sphere",
                       "implicit-albedo"):
            if v.has_embedding(legacy):
                v.remove_embedding(legacy)
        if v.has_embedding("sgm-depth") and not v.has_embedding("smvs-sgm"):
            v.set_image("smvs-sgm", np.asarray(v.get_image("sgm-depth")))
            v.remove_embedding("sgm-depth")
            if v.path:
                v.save()

    if conf.clean:
        print("Cleaning scene, removing all result embeddings.")
        scene.clean_embeddings()
        return 0

    by_id = {v.view_id: v for v in views}
    view_ids = [i for i in parse_view_list(conf.list_view, max(by_id) + 1)
                if i in by_id and by_id[i].camera is not None
                and by_id[i].has_embedding(conf.image)]

    # ---- input scale (reference `app/smvsrecon.cc:476-501`) ---------------
    # Sizes of every view with an input image (not just the -l list): view
    # selection and the downscale pass cover neighbor views too.
    all_input_ids = [v.view_id for v in views
                     if v.camera is not None and v.has_embedding(conf.image)]
    sizes = {}
    for i in all_input_ids:
        img = by_id[i].get_image(conf.image)
        if use_sgm and img.ndim == 3 and img.shape[2] != 1:
            raise NotImplementedError(
                f"view {i}: the SGM init takes gray views only, as the JAX "
                "CLI's does; give --no-sgm for color input images")
        sizes[i] = img.shape[:2]
    if conf.scale < 0:
        avg = np.mean([h * w for (h, w) in (sizes[i] for i in view_ids)])
        conf.scale = int(np.ceil(np.log2(avg / conf.max_pixels) / 2)) \
            if avg > conf.max_pixels else 0
        print(f"Automatic input scale: {conf.scale}")
    input_name = (f"undist-L{conf.scale}" if conf.scale > 0 else conf.image)
    output_name = ("smvs-S" if conf.shading else "smvs-B") + str(conf.scale)
    print(f"Input embedding: {input_name}")
    print(f"Output embedding: {output_name}")

    # ---- downscale inputs (reference :613-650) ----------------------------
    for i in all_input_ids:
        v = by_id[i]
        if conf.scale > 0 and not v.has_embedding(input_name):
            img = np.asarray(v.get_image(conf.image), np.float32)
            if img.dtype == np.uint8 or img.max() > 1.5:
                img = img / 255.0
            x = torch.as_tensor(img, device=dev)
            if x.ndim == 3:  # channels first for the [..., H, W] rescale
                x = torch.movedim(x, -1, 0)
            for _ in range(conf.scale):
                x = iops.rescale_half_size_gaussian(x)
            if x.ndim == 3:
                x = torch.movedim(x, 0, -1)
            v.set_image(input_name, np.clip(x.cpu().numpy() * 255, 0,
                                            255).astype(np.uint8))

    # ---- view selection (reference :560-611) ------------------------------
    cam_list = [by_id[i].camera if i in by_id else None
                for i in range(max(by_id) + 1)]
    size_list = [(sizes[i][1], sizes[i][0]) if i in sizes else (0, 0)
                 for i in range(max(by_id) + 1)]
    neighbors = {}
    for i in view_ids:
        nbrs = vs.get_neighbors_for_view(
            cam_list, size_list, bundle, i,
            vs.ViewSelectionOptions(num_neighbors=conf.neighbors))
        nbrs = [n for n in nbrs if n in by_id]
        if len(nbrs) < conf.min_neighbors:
            print(f"View {i}: only {len(nbrs)} neighbors, skipping.")
            continue
        neighbors[i] = nbrs

    recon_list = [i for i in neighbors
                  if conf.force or not by_id[i].has_embedding(output_name)]
    skipped = len(neighbors) - len(recon_list)
    if skipped:
        print(f"Skipping {skipped} views that are already reconstructed.")

    # ---- per-view reconstruction (reference :652-735) ---------------------
    def load_image(i):
        """View i's working image in [0, 1]: gray [H, W] or RGB [H, W, 3]."""
        img = np.asarray(by_id[i].get_image(input_name), np.float64)
        if img.max() > 1.5:
            img = img / 255.0
        return img.astype(np.float32)

    quantum = max(1, conf.pad_bucket)

    def padded_dims(h, w):
        return (-(-h // quantum) * quantum, -(-w // quantum) * quantum)

    def working_dims(i):
        h, w = sizes[i]
        for _ in range(conf.scale):
            h, w = (h + 1) // 2, (w + 1) // 2
        return h, w

    # One shared canvas (the largest padded working dims of all views):
    # SGM's neighbor images share the main image's shape.
    if quantum > 1:
        all_wd = [working_dims(i) for i in all_input_ids] or [(0, 0)]
        canvas = padded_dims(max(h for h, _ in all_wd),
                             max(w for _, w in all_wd))
    else:
        canvas = None

    def padded_image(i):
        """Working image on the shared canvas + the adjusted camera."""
        img = load_image(i)
        cam = by_id[i].camera
        h, w = img.shape[:2]
        ph, pw = canvas if canvas is not None else (h, w)
        if (ph, pw) != (h, w):
            pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pad, mode="edge")
            cam = cam.resized_canvas(w, h, pw, ph)
        return img, cam

    def stereo_view(i):
        img, cam = padded_image(i)
        return make_view(cam, img, view_id=i, device=dev,
                         gamma_correction=conf.gamma_srgb)

    def prepare_sgm(i, oh, ow, h, w):
        """SGM depth of view i (checkpointed as `smvs-sgm`) on the (h, w)
        canvas; (oh, ow) are the view's own working dims. A checkpointed
        map from an unpadded run is upsampled to (oh, ow) and zero-padded.
        """
        if conf.force_sgm or not by_id[i].has_embedding("smvs-sgm"):
            sgm_depth = reconstruct_sgm(conf, i, neighbors[i], padded_image,
                                        bundle, sgm_range, dev)
            by_id[i].set_image("smvs-sgm", np.asarray(depth_z_to_mve(
                np.asarray(sgm_depth, np.float64),
                by_id[i].camera.inverse_calibration(
                    *sgm_depth.shape[::-1]))).astype(np.float32))
        else:
            raw = np.asarray(by_id[i].get_image("smvs-sgm"), np.float64)
            sgm_depth = depth_mve_to_z(raw, by_id[i].camera.
                                       inverse_calibration(raw.shape[1],
                                                           raw.shape[0]))
        sgm_depth = np.asarray(sgm_depth, np.float32)
        sh, sw = sgm_depth.shape
        # Does the map cover the padded canvas, or only the view's own
        # working area (written by an unpadded run)?
        covers_canvas = abs(sh * (2**conf.sgm_scale) - h) <= \
            (2**conf.sgm_scale) and (h, w) != (oh, ow)
        th, tw = (h, w) if covers_canvas or (h, w) == (oh, ow) else (oh, ow)
        if (sh, sw) != (th, tw):  # nearest upsample to working res
            yy = (np.arange(th) * sh / th).astype(int)
            xx = (np.arange(tw) * sw / tw).astype(int)
            sgm_depth = sgm_depth[yy][:, xx]
        if sgm_depth.shape != (h, w):
            sgm_depth = np.pad(sgm_depth, ((0, h - sgm_depth.shape[0]),
                                           (0, w - sgm_depth.shape[1])))
        return sgm_depth

    def prepare_splat(i, oh, ow, h, w):
        """The sparse depth prior of view i (reference
        `Surface::initialize_depth_from_bundle`): its features' depths
        splatted at its (oh, ow) working dims, zero-padded to the (h, w)
        canvas."""
        init_depth = bundle.splat_depth_map(i, by_id[i].camera, ow, oh)
        if (h, w) != (oh, ow):
            init_depth = np.pad(init_depth, ((0, h - oh), (0, w - ow)))
        return init_depth

    def write_result(i, result, oh, ow):
        # Crop the padded canvas back to the view's working resolution.
        depth = result.depth.cpu().numpy().astype(np.float64)[:oh, :ow]
        normals = result.normals.cpu().numpy().astype(np.float32)[:oh, :ow]
        inv_cal = by_id[i].camera.inverse_calibration(ow, oh)
        by_id[i].set_image(output_name, np.asarray(
            depth_z_to_mve(depth, inv_cal), np.float32))
        by_id[i].set_image(output_name + "N", normals)
        if scene.path:
            by_id[i].save()

    opts = O.OptimizerOptions(
        regularization=0.01 * conf.alpha,
        light_surf_regularization=conf.regularize_lighting,
        num_iterations=5,
        min_scale=conf.output_scale,
        use_shading=conf.shading,
        use_sgm=use_sgm,
        full_optimization=conf.full_opt,
        debug_lvl=conf.debug_lvl,
    )
    log = print if conf.debug_lvl > 0 else None

    # Host-clock stage times; each stage ends in a copy to the host, which
    # waits for the device.
    timer = StageTimer()

    def prepare_init(i, oh, ow, main_v):
        """(sgm_depth, init_depth) of view i on its canvas; one is None."""
        if use_sgm:
            with timer.stage("sgm"):
                return prepare_sgm(i, oh, ow, main_v.height,
                                   main_v.width), None
        with timer.stage("splat"):
            return None, prepare_splat(i, oh, ow, main_v.height, main_v.width)

    def debug_sink(i):
        """Under -d above 1: writes view i's debug images as embeddings."""
        def sink(name, img):
            by_id[i].set_image(name, img.cpu().numpy().astype(np.float32))
        return sink if conf.debug_lvl > 1 else None

    # Group views into buckets of one shape (the padded working dims and
    # the neighbor count, as the JAX CLI keys them); a group of two or
    # more runs as one batch (the reference's per-view thread fan-out,
    # `app/smvsrecon.cc:558`).
    buckets: dict = {}
    for i in recon_list:
        buckets.setdefault((*padded_dims(*working_dims(i)),
                            len(neighbors[i])), []).append(i)
    t_all = time.time()
    for key, ids in buckets.items():
        for group in VB.group_views(ids, key, conf.batch_views, BATCH_MP):
            t0 = time.time()
            dims = [working_dims(i) for i in group]
            with timer.stage("views"):
                mains = [stereo_view(i) for i in group]
                subs_list = [[stereo_view(n) for n in neighbors[i]]
                             for i in group]
            inits = [prepare_init(i, oh, ow, m)
                     for i, (oh, ow), m in zip(group, dims, mains)]
            batched = len(group) >= 2 and conf.debug_lvl <= 1
            with timer.stage("optimize"):
                if batched:
                    results = VB.optimize_view_batch(
                        mains, subs_list, opts,
                        sgm_depths=[s for s, _ in inits] if use_sgm else None,
                        init_depths=None if use_sgm else [d for _, d in inits],
                        log=log, device=dev)
                else:
                    results = [O.optimize_view(
                        m, subs, opts, sgm_d, device=dev, log=log,
                        init_depth=init_d, debug_sink=debug_sink(i))
                        for i, m, subs, (sgm_d, init_d)
                        in zip(group, mains, subs_list, inits)]
                for i, result, (oh, ow) in zip(group, results, dims):
                    write_result(i, result, oh, ow)
            print(f"Views {group} done in {time.time()-t0:.1f}s "
                  f"({key[2]} neighbors, "
                  f"{'batched' if batched else 'sequential'})")
    print(f"Reconstruction took {time.time()-t_all:.1f}s")

    if not conf.recon_only:
        with timer.stage("fuse"):
            fuse(conf, scene, by_id, neighbors, output_name, load_image)
    print("Stage seconds: " + ", ".join(
        f"{name} {timer.totals[name]:.3f} ({timer.counts[name]} runs)"
        for name in ("views", "sgm", "splat", "optimize", "fuse")
        if name in timer.totals))
    return 0


def fuse(conf, scene, by_id, neighbors, output_name, load_image) -> None:
    """Fuse every reconstructed view into `smvs-B<scale>.ply` (under -S
    `smvs-S<scale>.ply`; with -m the mesh `smvs-m-B<scale>.ply` or
    `smvs-m-S<scale>.ply`) in the scene directory (reference
    `generate_mesh`, `app/smvsrecon.cc:278-343`), on the host, colored by
    the working images."""
    depths, normals, cams, colors = [], [], [], []
    for i in sorted(neighbors):
        v = by_id[i]
        if not v.has_embedding(output_name):
            continue
        raw = np.asarray(v.get_image(output_name), np.float64)
        ic = v.camera.inverse_calibration(raw.shape[1], raw.shape[0])
        depths.append(depth_mve_to_z(raw, ic))
        normals.append(np.asarray(v.get_image(output_name + "N"), np.float32))
        cams.append(v.camera)
        colors.append(load_image(i))
    ps = pc.fuse_views(depths, normals, cams, colors,
                       pc.FusionOptions(cut_surfaces=not conf.no_cut,
                                        create_triangle_mesh=conf.mesh,
                                        simplify=conf.simplify))
    if conf.aabb:
        vals = [float(x) for x in conf.aabb.split(",")]
        ps = pc.clip_aabb(ps, vals[:3], vals[3:])
    mesh_name = ("smvs-" + ("m-" if conf.mesh else "")
                 + ("S" if conf.shading else "B") + f"{conf.scale}.ply")
    out_path = os.path.join(scene.path or ".", mesh_name)
    save_ply(out_path, ps)
    print(f"Saved {len(ps.vertices)} points to {out_path}")


def reconstruct_sgm(conf, i, nbrs, padded_image, bundle, sgm_range,
                    device: torch.device) -> np.ndarray:
    """SGM of up to 2 neighbors, averaged (reference
    `app/smvsrecon.cc:347-384`), on the shared padded canvas
    (`padded_image` returns the gray image + exactly adjusted camera).
    Returns the z-depth map at the SGM scale."""

    def at_sgm_scale(img):
        x = torch.as_tensor(img * 255.0, device=device)
        for _ in range(conf.sgm_scale):
            x = iops.rescale_half_size(x)
        return x

    img_i, cam_i = padded_image(i)
    main_img = at_sgm_scale(img_i)
    h, w = main_img.shape

    def depth_range(view_id, cam, width, height):
        if sgm_range is not None:
            return sgm_range
        d = bundle.feature_depths_for_view(view_id, cam, width, height)
        return sgm.depth_range_from_features(d)

    opts = sgm.SGMOptions(scale=conf.sgm_scale, debug_lvl=conf.debug_lvl)
    cams, imgs, ranges = [], [], []
    for n in nbrs[:2]:
        img_n, cam_n = padded_image(n)
        nb_img = at_sgm_scale(img_n)
        hn, wn = nb_img.shape
        cams.append(cam_n)
        imgs.append(nb_img)
        ranges.append(depth_range(n, cam_n, wn, hn))
    depth = sgm.reconstruct_auto_multi(
        cam_i, cams, main_img, imgs, range_main=depth_range(i, cam_i, w, h),
        ranges_nbr=ranges, opts=opts, device=device)
    return depth.cpu().numpy()


if __name__ == "__main__":
    sys.exit(main())
