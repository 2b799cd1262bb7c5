"""Reference results of the JAX package, on the CPU, for the limits that
`chip_smoke.py` holds the PyTorch/CUDA port to.

Thirteen configurations, each at a dimension the caller picks (the card
runs them at 1440, 1280 (the CLI ones) and 1440; a CPU run at that size
holds many GB, so the reference is mostly taken at a smaller one and the
script's output says which):

    python tools/jax_cpu_reference.py general --dim 720
    python tools/jax_cpu_reference.py cli --dim 640
    python tools/jax_cpu_reference.py forward --dim 960
    python tools/jax_cpu_reference.py shading --dim 640
    python tools/jax_cpu_reference.py color --dim 640
    python tools/jax_cpu_reference.py fullopt --dim 640
    python tools/jax_cpu_reference.py mesh --dim 640
    python tools/jax_cpu_reference.py flagship --dim 1440
    python tools/jax_cpu_reference.py batch --dim 720
    python tools/jax_cpu_reference.py step --dim 480
    python tools/jax_cpu_reference.py pipeline --dim 480 --patch 2

`general`: `stereo.reconstruct` (the general-warp SGM, 128 planes, range
(4.0, 8.5)) on the two-view scene of tests/test_sgm.py, with the plane's
slope per pixel scaled by 160/dim so its depths stay inside the sweep
range at any dim. Prints coverage and the median relative error against
the analytic depth.

`cli`: the `smvsrecon` CLI with its defaults (and `--batch-views 1`) on a
4-view `make_plane_scene` written as an MVE scene. Prints the fused point
count and the median relative error of the fused points against the
analytic depth of view 1 (as tests/test_cli.py reckons it).

`forward`: the same CLI run on the plane seen by four views moving toward
it (`smvs_tpu_torch.core.synthetic.forward_cameras`): no pair rectifies,
so every SGM pair takes the general warp. Both scenes are written by the
port's numpy code, whose files and pixels equal the JAX package's.

`shading`: the CLI with `-S` (the shading-aware optimizer, otherwise its
defaults) on the scene of `cli`; reads `smvs-S0.ply`.

`color`: the plane scene with RGB views whose channels differ
(`make_plane_scene(color=True)`), run twice in one directory: with
`--no-sgm` (the sparse-prior init from the bundle's features; the JAX
CLI's SGM takes gray views only), then with `--no-sgm -S -g`. Its bundle
holds `features(dim)` points, the density of the 200 of a 160 px scene:
the splat init needs a few features in each node's window, and at 640 px
200 features leave most windows empty and the CLI fuses no point.

`fullopt`: the scene of `cli` with `--full-opt -m` (every node active in
every Newton step, a triangle mesh per view), then `-m -y` in the same
directory, which skips the reconstructed views and only fuses them into
the greedy simplified meshes. `mesh`: the same with `-m`, then `-m -y`.
Each run of a configuration prints its points per pixel (vertices for a
mesh), its faces and its median fused error.

`flagship`: `bench.py:run_shading_once(dim, 2)`, the shading-aware
flagship (JAX float32 on the CPU); prints its coverage and median
relative error.

`batch`: the CLI with all its defaults, `--batch-views 4` among them, on
8 views of `bench_dtu.py`'s camera grid (`make_dtu_scene`) whose sizes
alternate dim and dim * 1280 / 1440, as `bench_dtu.py` mixes them; the
card runs dim 1440, whose auto input scale of 1 gives working views of
720 and 640 px, the sizes `--dim 720` gives at scale 0. Prints the
fused points per working pixel, the median fused error, and the CLI's
`Views [...] done` lines (its groups, batched or sequential).

`step`: the sharded Newton step of `smvs_tpu/dist/viewbatch.py`
(`training_step_fn`) in float32 on `make_view_batch(4, dim, scale 2)`
over the 8 virtual CPU devices, on the meshes (1, 1), (4, 1) and (8, 2):
each mesh's largest distance from the single-device float32 step, the
share of entries outside the JAX multihost worker's bar (rtol 2e-3, atol
5e-5), and the single-device float32 step's distance from the float64
one. With `--port`, the same for the port: its single-process step in
float32 and float64, and its sharded step on (1, 2) and (2, 2) meshes of
gloo ranks on the CPU (`smvs_tpu_torch.dist`).

`pipeline`: `bench.py:run_once`'s view (the two-view slanted plane, its
rectified SGM depth) through the batched pipeline `optimize_view_batch`
with each view's node rows split over a 'patch' axis of ``--patch``
(`make_view_mesh(P, patch_axis=P)` of the 8 virtual CPU devices; the
JAX package splits an array's rows only where the axis divides them),
against the same pipeline unsharded, in float32: under the JAX dry run's
`fixed_newton_steps` (6 Newton steps a loop) and under run_once's
options. For each: the share of pixels whose coverage flips, the share
of the commonly covered ones drifting by more than 2e-4, the largest
relative drift, and each run's coverage and median relative error
against the analytic depth. With `--port`, the port's sharded pipeline
on a (1, P) mesh of gloo ranks on the CPU against its unsharded batch.
`--scene plane` runs four views of `make_plane_scene(7, dim)` instead
(views 0, 2, 4 and 6, each against one neighbor, from their analytic
depths, down to scale 3), batched: where the Newton and PCG exits differ.

`costinterp`: `stereo.reconstruct_auto` with `SGMOptions(cost_interp=True)`
(the cost-space interpolated cost volume) on `bench.py:run_once`'s
two-view scene at dim: the SGM depth map's coverage and median relative
error against the analytic depth, and the same for the default cost.

`scene`: the JAX repository's `bench_scene.py` (10 plane views of dim,
SGM against the 2 nearest, `optimize_view_batch` in groups of 5, a warm
pass), its JSON line. `dtu`: `bench_dtu.py` on 10 views of its camera
grid, 7 of dim and 3 of dim * 1280 / 1440 (two shape buckets), at input
scale 0, written to a fresh directory, its JSON line. The card runs
`scene` at 720 and `dtu` at 1440 (`chip_smoke.py` phase 17):

    python tools/jax_cpu_reference.py costinterp --dim 720
    python tools/jax_cpu_reference.py scene --dim 720
    python tools/jax_cpu_reference.py dtu --dim 720

`--port` runs the PyTorch port's CLI (`--device cpu`) on the same scene
instead (for `scene` and `dtu`, the port's drivers), to tell a
difference of the card from one of the size:

    python tools/jax_cpu_reference.py forward --dim 960 --port
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if sys.argv[1:2] in (["step"], ["pipeline"]) and "xla_force_host_platform_device_count" \
        not in os.environ.get("XLA_FLAGS", ""):  # the 8-device CPU mesh
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def general(dim: int) -> dict:
    from smvs_tpu.core.synthetic import make_two_view_scene
    from smvs_tpu.sgm import stereo as sgm

    slope = 0.005 * 160.0 / dim
    scene = make_two_view_scene(
        dim=dim, rotate=False, baseline=0.25, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    cm, cn = scene.cameras[1], scene.cameras[0]
    M_mn, t_mn = cm.fill_reprojection(cn, dim, dim, dim, dim)
    M_nm, t_nm = cn.fill_reprojection(cm, dim, dim, dim, dim)
    mats = [jnp.asarray(a, jnp.float32) for a in (M_mn, t_mn, M_nm, t_nm)]
    t0 = time.perf_counter()
    depth = np.asarray(sgm.reconstruct(
        jnp.asarray(scene.images[1] * np.float32(255.0)),
        jnp.asarray(scene.images[0] * np.float32(255.0)), *mats,
        (4.0, 8.5), (4.0, 8.5), sgm.SGMOptions(num_steps=128)))
    seconds = time.perf_counter() - t0
    gt = scene.depths[1]
    mask = depth > 0
    rel = np.abs(depth[mask] - gt[mask]) / gt[mask]
    return {"coverage": float(mask.mean()),
            "median_rel_err": float(np.median(rel)),
            "cpu_seconds": seconds}


def fused_error(vertices: np.ndarray, scene, view: int = 1) -> float:
    """Median relative depth error of fused points seen by ``view``."""
    cam = scene.cameras[view]
    p_cam = vertices @ cam.rot.T + cam.trans
    uv = cam.project(p_cam, scene.width, scene.height)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < scene.width) & \
        (uv[:, 1] >= 0) & (uv[:, 1] < scene.height) & (p_cam[:, 2] > 0)
    xi = np.clip(uv[inb, 0].astype(int), 0, scene.width - 1)
    yi = np.clip(uv[inb, 1].astype(int), 0, scene.height - 1)
    gt = scene.depths[view][yi, xi]
    ok = gt > 0
    return float(np.median(np.abs(p_cam[inb][ok, 2] - gt[ok]) / gt[ok]))


# The CLI configurations: (RGB views, forward motion, the runs made in
# turn on one scene directory as (flags, the PLY it writes)).
RUNS = {
    "cli": (False, False, [([], "smvs-B0.ply")]),
    "forward": (False, True, [([], "smvs-B0.ply")]),
    "shading": (False, False, [(["-S"], "smvs-S0.ply")]),
    "color": (True, False, [(["--no-sgm"], "smvs-B0.ply"),
                            (["--no-sgm", "-S", "-g"], "smvs-S0.ply")]),
    "fullopt": (False, False, [(["--full-opt", "-m"], "smvs-m-B0.ply"),
                               (["-m", "-y"], "smvs-m-B0.ply")]),
    "mesh": (False, False, [(["-m"], "smvs-m-B0.ply"),
                            (["-m", "-y"], "smvs-m-B0.ply")]),
}


def features(dim: int) -> int:
    """Bundle features of a `color` scene of dim x dim views: 200 at 160
    px, the same density at any size."""
    return round(200 * (dim / 160) ** 2)


def cli(config: str, dim: int, port: bool = False) -> dict:
    from smvs_tpu import cli as smvs_cli
    from smvs_tpu.mesh.ply import load_ply
    from smvs_tpu_torch import cli as port_cli
    # The port's numpy scene code: bit-equal to the JAX package's scenes,
    # and it also places the forward-motion cameras and colors the views.
    from smvs_tpu_torch.core.synthetic import (forward_cameras,
                                               make_plane_scene,
                                               save_as_mve_scene)

    color, forward, runs = RUNS[config]
    n_views = 4
    scene = make_plane_scene(n_views=n_views, dim=dim, color=color,
                             cameras=forward_cameras() if forward else None)
    out = []
    with tempfile.TemporaryDirectory() as path:
        save_as_mve_scene(scene, path,
                          n_features=features(dim) if color else 200)
        for flags, ply in runs:
            t0 = time.perf_counter()
            rc = port_cli.main([path, "--device", "cpu", *flags]) if port \
                else smvs_cli.main([path, "--platform", "cpu",
                                    "--batch-views", "1", *flags])
            seconds = time.perf_counter() - t0
            ps = load_ply(os.path.join(path, ply))
            out.append({
                "flags": flags, "rc": rc, "points": int(len(ps.vertices)),
                "points_per_pixel": len(ps.vertices) / (n_views * dim * dim),
                "faces": 0 if ps.faces is None else int(len(ps.faces)),
                "median_fused_rel_err": fused_error(ps.vertices, scene),
                "cpu_seconds": seconds})
    return {**out[0], "runs": out}


def batch_dims(dim: int, n_views: int = 8) -> list[int]:
    """The `batch` scene's view sizes: dim and dim * 1280 / 1440 in turn."""
    return [dim if i % 2 == 0 else dim * 1280 // 1440
            for i in range(n_views)]


def input_scale(dims: list[int], max_pixels: float = 1.7e6) -> int:
    """The CLI's automatic input scale for views of these sizes."""
    avg = np.mean([d * d for d in dims])
    return int(np.ceil(np.log2(avg / max_pixels) / 2)) \
        if avg > max_pixels else 0


def working_pixels(dims: list[int]) -> int:
    """Pixels of the views at the CLI's automatic input scale."""
    total = 0
    for d in dims:
        for _ in range(input_scale(dims)):
            d = (d + 1) // 2
        total += d * d
    return total


def batch(dim: int, port: bool = False) -> dict:
    import contextlib
    import io
    import re

    from smvs_tpu import cli as smvs_cli
    from smvs_tpu.mesh.ply import load_ply
    from smvs_tpu_torch import cli as port_cli
    from smvs_tpu_torch.core.synthetic import make_dtu_scene, \
        save_as_mve_scene

    dims = batch_dims(dim)
    scene = make_dtu_scene(len(dims), dims)
    with tempfile.TemporaryDirectory() as path:
        save_as_mve_scene(scene, path)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = port_cli.main([path, "--device", "cpu"]) if port \
                else smvs_cli.main([path, "--platform", "cpu"])
        seconds = time.perf_counter() - t0
        ps = load_ply(os.path.join(path, f"smvs-B{input_scale(dims)}.ply"))
    text = out.getvalue()
    pixels = working_pixels(dims)
    return {"dims": dims, "rc": rc, "points": int(len(ps.vertices)),
            "working_pixels": pixels,
            "points_per_pixel": len(ps.vertices) / pixels,
            "median_fused_rel_err": fused_error(ps.vertices, scene),
            "groups": re.findall(r"Views \[.*", text),
            "input_scale": input_scale(dims), "cpu_seconds": seconds}


def flagship(dim: int, port: bool = False) -> dict:
    if port:
        from smvs_tpu_torch import bench_main
        out = bench_main.run_shading_once(dim, 2, device="cpu")
    else:
        import bench
        out = bench.run_shading_once(dim, 2, verbose=False)
    return dict(zip(("t_sgm", "t_opt", "coverage", "median_rel_err"), out))


def cost_interp(dim: int, port: bool = False) -> dict:
    from smvs_tpu.core import synthetic as jsyn

    slope = 0.005 * 460.0 / dim
    scene = jsyn.make_two_view_scene(
        dim=dim, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    main = scene.images[1] * np.float32(255.0)
    nbr = scene.images[0] * np.float32(255.0)
    gt = scene.depths[1]
    out = {}
    for key, interp in (("default", False), ("cost_interp", True)):
        t0 = time.time()
        if port:
            from smvs_tpu_torch.sgm import stereo as tst
            depth = tst.reconstruct_auto(
                scene.cameras[1], scene.cameras[0], main, nbr, (3.5, 9.5),
                (3.5, 9.5), tst.SGMOptions(cost_interp=interp),
                device="cpu").numpy()
        else:
            from smvs_tpu.sgm import stereo as jst
            depth = np.asarray(jst.reconstruct_auto(
                scene.cameras[1], scene.cameras[0], jnp.asarray(main),
                jnp.asarray(nbr), (3.5, 9.5), (3.5, 9.5),
                jst.SGMOptions(cost_interp=interp)))
        m = depth > 0
        out[key] = {"coverage": float(m.mean()),
                    "median_rel_err": float(np.median(
                        np.abs(depth[m] - gt[m]) / gt[m])),
                    "cpu_seconds": time.time() - t0}
    return out


def _driver_json(main) -> dict:
    """The JSON line a benchmark driver's ``main()`` prints last."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def scene_bench(dim: int, port: bool = False) -> dict:
    if port:
        from smvs_tpu_torch import bench_scene as tbs
        return tbs.run(dim=dim, device="cpu")
    import bench_scene
    os.environ.update(SMVS_SCENE_DIM=str(dim), SMVS_SCENE_VIEWS="10",
                      SMVS_SCENE_BATCH="5", SMVS_SCENE_MIN_SCALE="2")
    return _driver_json(bench_scene.main)


def dtu_bench(dim: int, port: bool = False) -> dict:
    dim2 = dim * 1280 // 1440
    path = os.path.join(tempfile.mkdtemp(), "dtu")
    if port:
        from smvs_tpu_torch import bench_dtu as tbd
        return tbd.run(n_views=10, dim1=dim, dim2=dim2, scene_dir=path,
                       device="cpu")
    import bench_dtu
    os.environ.update(SMVS_DTU_VIEWS="10", SMVS_DTU_DIM=str(dim),
                      SMVS_DTU_DIM2=str(dim2), SMVS_DTU_SCALE="0",
                      SMVS_DTU_DIR=path)
    return _driver_json(bench_dtu.main)


STEP_ARGS = ("nodes", "node_valid", "patch_valid", "vis", "active", "view")
STEP_RTOL, STEP_ATOL = 2e-3, 5e-5  # smvs_tpu/dist/multihost.py:96-101


def _gaps(got: np.ndarray, want: np.ndarray) -> dict:
    diff = np.abs(got - want)
    return {"max_abs": float(diff.max()),
            "outside_bar": float((diff > STEP_ATOL + STEP_RTOL
                                  * np.abs(want)).mean())}


def _port_step_rank(rank, world, dev, dim, patch):
    import torch

    from smvs_tpu_torch.dist import mesh as M
    from smvs_tpu_torch.dist import testing, viewbatch
    from smvs_tpu_torch.solver import gn

    template, batch = testing.make_view_batch(4, dim=dim, scale=2, device=dev)
    mesh = M.make_mesh(world, patch_axis=patch, device=dev)
    shard = viewbatch.training_step_fn(template, gn.GNOptions(), mesh)(
        *(batch[k] for k in STEP_ARGS))
    return viewbatch.gather_nodes(shard, mesh)


def step(dim: int, port: bool = False) -> dict:
    out = {"scale": 2}
    if port:
        import torch

        from smvs_tpu_torch.dist import launch, testing, viewbatch
        from smvs_tpu_torch.solver import gn

        torch.set_num_threads(1)
        ref = {}
        for dt in (torch.float32, torch.float64):
            t, b = testing.make_view_batch(4, dim=dim, scale=2, dtype=dt,
                                           device="cpu")
            ref[dt] = viewbatch.batched_newton_step(t, gn.GNOptions())(
                *(b[k] for k in STEP_ARGS)).numpy()
        single, single64 = ref[torch.float32], ref[torch.float64]
        for views, patch in ((1, 2), (2, 2)):
            with tempfile.TemporaryDirectory() as d:
                got = launch.spawn(_port_step_rank, views * patch,
                                   backend="gloo", device="cpu",
                                   store_path=os.path.join(d, "store"),
                                   args=(dim, patch))[0].numpy()
            out[f"mesh ({views}, {patch})"] = {
                **_gaps(got, single), "vs_float64":
                    float(np.abs(got - single64).max())}
    else:
        from smvs_tpu.dist import testing, viewbatch
        from smvs_tpu.solver import gn

        ref = {}
        for dt in (jnp.float32, jnp.float64):
            if dt == jnp.float64:
                jax.config.update("jax_enable_x64", True)
            t, b = testing.make_view_batch(4, dim=dim, scale=2, dtype=dt)
            step_fn = jax.jit(viewbatch.batched_newton_step(
                t, gn.GNOptions(chunk=32)))
            ref[dt] = np.asarray(step_fn(*(b[k] for k in STEP_ARGS)))
        jax.config.update("jax_enable_x64", False)
        single, single64 = ref[jnp.float32], ref[jnp.float64]
        t, b = testing.make_view_batch(4, dim=dim, scale=2)
        for n, patch in ((1, 1), (4, 1), (8, 2)):
            fn = viewbatch.training_step_fn(t, gn.GNOptions(chunk=32),
                                            viewbatch.make_mesh(n, patch))
            got = np.asarray(fn(*(b[k] for k in STEP_ARGS)))
            out[f"mesh ({n // patch}, {patch})"] = {
                **_gaps(got, single), "vs_float64":
                    float(np.abs(got - single64).max())}
    out["single_float32_vs_float64"] = float(np.abs(single - single64).max())
    return out


def _pipeline_options(O, min_scale: int = 2) -> dict:
    """run_once's optimizer options, and the same under the JAX dry run's
    fixed Newton steps."""
    base = dict(regularization=0.01, num_iterations=5, min_scale=min_scale,
                use_sgm=True)
    return {"fixed": O.OptimizerOptions(**base, max_newton_steps=6,
                                        fixed_newton_steps=True),
            "defaults": O.OptimizerOptions(**base)}


def _depth_gaps(got: np.ndarray, want: np.ndarray, gt: np.ndarray) -> dict:
    both = (got > 0) & (want > 0)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    return {"mask_flips": float(((got > 0) != (want > 0)).mean()),
            "drift_share": float((rel[both] > 2e-4).mean()),
            "max_rel_drift": float(rel[both].max()),
            "coverage": [float((got > 0).mean()), float((want > 0).mean())],
            "median_rel_err": [
                float(np.median(np.abs(d[d > 0] - gt[d > 0]) / gt[d > 0]))
                for d in (got, want)]}


def _port_pipeline_rank(rank, world, dev, path, patch):
    import torch

    from smvs_tpu_torch.pipeline import batch as B

    data = torch.load(path, weights_only=False)
    mesh = B.make_view_mesh(world, patch_axis=patch, device=dev)
    return {name: [r.depth for r in B.optimize_view_batch(
        data["mains"], data["subs_list"], opts,
        sgm_depths=data["sgm_depths"], mesh=mesh, device=dev)]
        for name, opts in data["opts"].items()}


def _pipeline_problem(scene: str, dim: int, port: bool):
    """(mains, neighbor lists, SGM depths, analytic depths, min_scale) of
    the scene, as the port's views or the JAX package's."""
    from smvs_tpu_torch.core.synthetic import make_plane_scene, \
        make_two_view_scene

    if port:
        from smvs_tpu_torch.pipeline.views import make_view
        from smvs_tpu_torch.sgm import stereo as sgm
        kw = {"device": "cpu"}
    else:
        from smvs_tpu.pipeline.views import make_view
        from smvs_tpu.sgm import stereo as sgm
        kw = {}
    if scene == "main":
        slope = 0.005 * 460.0 / dim  # bench.py:run_once's scene
        sc = make_two_view_scene(
            dim=dim, rotate=True, texture="noise",
            depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
        main_v, sub_v = (make_view(sc.cameras[i], sc.images[i], view_id=i,
                                   **kw) for i in (1, 0))
        depth = sgm.reconstruct_auto(
            sc.cameras[1], sc.cameras[0], main_v.image * 255.0,
            sub_v.image * 255.0, range_main=(3.5, 9.5),
            range_nbr=(3.5, 9.5), **kw)
        return [main_v], [[sub_v]], [depth], [sc.depths[1]], 2
    sc = make_plane_scene(n_views=7, dim=dim)
    views = [make_view(sc.cameras[i], sc.images[i], view_id=i, **kw)
             for i in range(7)]
    nbr = {0: 1, 2: 1, 4: 3, 6: 5}
    depths = [sc.depths[i].astype(np.float32) for i in nbr]
    if not port:
        depths = [jnp.asarray(d) for d in depths]
    return ([views[i] for i in nbr], [[views[j]] for j in nbr.values()],
            depths, [sc.depths[i] for i in nbr], 3)


def pipeline(dim: int, patch: int, scene: str, port: bool = False) -> dict:
    mains, subs, sgms, gts, min_scale = _pipeline_problem(scene, dim, port)
    out = {"scene": scene, "patch": patch, "min_scale": min_scale}
    if port:
        import torch

        from smvs_tpu_torch.dist import launch
        from smvs_tpu_torch.pipeline import batch as B
        from smvs_tpu_torch.pipeline import optimizer as O

        torch.set_num_threads(1)
        opts = _pipeline_options(O, min_scale)
        ref = {name: [r.depth.numpy() for r in B.optimize_view_batch(
            mains, subs, o, sgm_depths=sgms, device="cpu")]
            for name, o in opts.items()}
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "problem.pt")
            torch.save({"mains": mains, "subs_list": subs,
                        "sgm_depths": sgms, "opts": opts}, path)
            got = launch.spawn(_port_pipeline_rank, patch, backend="gloo",
                               device="cpu",
                               store_path=os.path.join(d, "store"),
                               args=(path, patch), timeout=3600)[0]
        got = {k: [t.numpy() for t in v] for k, v in got.items()}
    else:
        from smvs_tpu.pipeline import batch as B
        from smvs_tpu.pipeline import optimizer as O

        opts = _pipeline_options(O, min_scale)
        mesh = B.make_view_mesh(patch, patch_axis=patch)
        ref, got = {}, {}
        for name, o in opts.items():
            for dst, m in ((ref, None), (got, mesh)):
                dst[name] = [np.asarray(r.depth) for r in
                             B.optimize_view_batch(mains, subs, o,
                                                   sgm_depths=sgms, mesh=m)]
    for name in ref:
        out[name] = [_depth_gaps(g, w, gt)
                     for g, w, gt in zip(got[name], ref[name], gts)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config",
                    choices=("general", "flagship", "batch", "step",
                             "pipeline", "costinterp", "scene", "dtu",
                             *RUNS))
    ap.add_argument("--dim", type=int, required=True)
    ap.add_argument("--patch", type=int, default=2,
                    help="pipeline: the 'patch' axis")
    ap.add_argument("--scene", choices=("main", "plane"), default="main",
                    help="pipeline: run_once's view, or four plane views")
    ap.add_argument("--port", action="store_true",
                    help="run the PyTorch port instead (every "
                         "configuration but general)")
    args = ap.parse_args(argv)
    if args.config == "general":
        out = general(args.dim)
    elif args.config == "flagship":
        out = flagship(args.dim, port=args.port)
    elif args.config == "batch":
        out = batch(args.dim, port=args.port)
    elif args.config == "step":
        out = step(args.dim, port=args.port)
    elif args.config == "pipeline":
        out = pipeline(args.dim, args.patch, args.scene, port=args.port)
    elif args.config == "costinterp":
        out = cost_interp(args.dim, port=args.port)
    elif args.config == "scene":
        out = scene_bench(args.dim, port=args.port)
    elif args.config == "dtu":
        out = dtu_bench(args.dim, port=args.port)
    else:
        out = cli(args.config, args.dim, port=args.port)
    print(json.dumps({"config": args.config, "dim": args.dim,
                      "package": "smvs_tpu_torch" if args.port
                      else "smvs_tpu", "device": "cpu", **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
