"""The port's CLI on color views against the JAX CLI, end to end on the
CPU: two copies of one 4-view color plane scene (channels that differ,
`make_plane_scene(color=True)`), one reconstructed by each CLI, first
with `--no-sgm` (the sparse-prior init from the bundle's features), then
with `--no-sgm -S -g` (the shading-aware optimizer on the sRGB-decoded
luminance) in the same directories.

The JAX CLI's SGM init takes gray views only (it fails on a color view in
`reconstruct_sgm`), so color views are held against it with `--no-sgm`;
the port raises on a color view with SGM on (tests/test_torch_cli.py).
The scene and `-o 3` are those of tests/test_torch_cli.py.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from smvs_tpu import cli as jcli
from smvs_tpu.core import scene as jsc
from smvs_tpu.mesh.ply import load_ply
from smvs_tpu_torch import cli as tcli
from smvs_tpu_torch.core import synthetic as tsyn
from torch_threads import one_torch_thread  # noqa: F401

DIM = 160
ARGS = ["-o", "3"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_color")
    scene = tsyn.make_plane_scene(n_views=4, dim=DIM, color=True)
    paths = {k: str(root / k) for k in ("jax", "port")}
    for path in paths.values():
        tsyn.save_as_mve_scene(scene, path)
    out = {"scene": scene, **paths}
    for key, flags in (("base", ["--no-sgm"]),
                       ("shading", ["--no-sgm", "-S", "-g"])):
        jrc, _ = _run(jcli.main, [paths["jax"], "--platform", "cpu",
                                  "--batch-views", "1", *flags, *ARGS])
        trc, tout = _run(tcli.main, [paths["port"], "--device", "cpu",
                                     *flags, *ARGS])
        out[key] = dict(jrc=jrc, trc=trc, tout=tout)
    return out


def _embeddings(path, name):
    return [np.asarray(v.get_image(name))
            for v in jsc.Scene.load(path).views]


def _fused(path, name, scene):
    """(points, points per pixel, median relative error of the fused
    points against view 1's analytic depth, as tests/test_cli.py reckons
    it, colors)."""
    ps = load_ply(os.path.join(path, name))
    cam = scene.cameras[1]
    p_cam = ps.vertices @ cam.rot.T + cam.trans
    uv = cam.project(p_cam, DIM, DIM)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < DIM) & (uv[:, 1] >= 0) & \
        (uv[:, 1] < DIM) & (p_cam[:, 2] > 0)
    gt = scene.depths[1][uv[inb, 1].astype(int), uv[inb, 0].astype(int)]
    rel = np.abs(p_cam[inb, 2] - gt) / gt
    return (len(ps.vertices), len(ps.vertices) / (4 * DIM * DIM),
            float(np.median(rel)), ps.colors)


def test_cli_color_no_sgm_runs(runs):
    for key in ("base", "shading"):
        assert runs[key]["jrc"] == 0 and runs[key]["trc"] == 0, key
    out = runs["base"]["tout"]
    assert "smvs-sgm" not in out and "Stage seconds:" in out
    assert "splat" in out and " sgm " not in out
    for v in jsc.Scene.load(runs["port"]).views:
        assert not v.has_embedding("smvs-sgm")
        assert v.has_embedding("smvs-B0") and v.has_embedding("smvs-S0")


def test_cli_color_no_sgm_depths_match_jax(runs):
    """By the optimizer bar: the same mask, rtol 1.5e-3, fewer than 10%
    of pixels drifting by > 2e-4."""
    for want, got in zip(_embeddings(runs["jax"], "smvs-B0"),
                         _embeddings(runs["port"], "smvs-B0")):
        assert got.shape == want.shape == (DIM, DIM)
        np.testing.assert_array_equal(got > 0, want > 0)
        m = want > 0
        assert m.mean() > 0.6
        np.testing.assert_allclose(got[m], want[m], rtol=1.5e-3)
        rel = np.abs(got[m] - want[m]) / np.abs(want[m])
        assert (rel > 2e-4).mean() < 0.1


def test_cli_color_no_sgm_point_cloud_matches_jax(runs):
    """Within 1% of JAX's point count, on the analytic plane, and colored
    from the RGB image: the channels differ, and their means are JAX's
    within one level."""
    want = _fused(runs["jax"], "smvs-B0.ply", runs["scene"])
    got = _fused(runs["port"], "smvs-B0.ply", runs["scene"])
    assert want[0] > 1000
    assert abs(got[0] - want[0]) <= 0.01 * want[0]
    assert got[2] < 0.01 and got[2] <= 3 * want[2] + 1e-5
    assert got[3].shape == (got[0], 3) and got[3].dtype == np.uint8
    assert np.abs(got[3][:, 0].astype(int) - got[3][:, 1]).max() > 10
    np.testing.assert_allclose(got[3].mean(0), want[3].mean(0), atol=1.0)


def test_cli_color_shading_srgb_matches_jax_class(runs):
    """`--no-sgm -S -g`: the shading endpoint is chaotic (PERF_NOTES.md
    r5), so the class of tests/test_torch_cli.py: points per pixel within
    20% of JAX's, median fused error at most twice JAX's or 1e-2."""
    want = _fused(runs["jax"], "smvs-S0.ply", runs["scene"])
    got = _fused(runs["port"], "smvs-S0.ply", runs["scene"])
    assert want[1] > 0.1, want[:3]
    assert abs(got[1] - want[1]) <= 0.2 * want[1], (got[:3], want[:3])
    assert got[2] <= max(2 * want[2], 1e-2), (got[:3], want[:3])
