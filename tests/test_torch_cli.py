"""The port's `smvsrecon` CLI against the JAX package's, end to end on the
CPU: two copies of one 4-view plane scene, one reconstructed by each CLI.

The scene is 160 px wide, so the default `--sgm-scale 1` runs SGM at 80 px
(the smallest size with SGM coverage recorded in ROADMAP.md is 64; at 64
px wide XLA's CPU code sums the SGM-scale box filter pairwise, which the
port does not mimic, see `tests/test_torch_scene.py`). `-o 3` stops the
optimizer at scale 3, where the two packages agree pixel by pixel.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from smvs_tpu import cli as jcli
from smvs_tpu.core import scene as jsc
from smvs_tpu.core import synthetic as jsyn
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
    root = tmp_path_factory.mktemp("cli")
    jpath, tpath = str(root / "jax"), str(root / "port")
    jsyn.save_as_mve_scene(jsyn.make_plane_scene(n_views=4, dim=DIM), jpath)
    scene = tsyn.make_plane_scene(n_views=4, dim=DIM)
    tsyn.save_as_mve_scene(scene, tpath)
    jrc, _ = _run(jcli.main, [jpath, "--platform", "cpu", "--batch-views",
                              "1", *ARGS])
    trc, tout = _run(tcli.main, [tpath, "--device", "cpu", *ARGS])
    return dict(jpath=jpath, tpath=tpath, jrc=jrc, trc=trc, tout=tout,
                scene=scene, root=root)


def _embeddings(path, name):
    return [np.asarray(v.get_image(name))
            for v in jsc.Scene.load(path).views]


def test_cli_runs_and_writes_every_stage(runs):
    assert runs["jrc"] == 0 and runs["trc"] == 0
    out = runs["tout"]
    assert "Automatic input scale: 0" in out
    assert "Saved " in out
    for v in range(4):
        vdir = os.path.join(runs["tpath"], "views", f"view_{v:04d}.mve")
        for name in ("smvs-sgm", "smvs-B0", "smvs-B0N"):
            assert os.path.exists(os.path.join(vdir, name + ".mvei"))
    assert os.path.exists(os.path.join(runs["tpath"], "smvs-B0.ply"))


def test_cli_sgm_embeddings_match_jax(runs):
    """By the `reconstruct_auto` tolerance (tests/test_torch_sgm.py)."""
    for want, got in zip(_embeddings(runs["jpath"], "smvs-sgm"),
                         _embeddings(runs["tpath"], "smvs-sgm")):
        assert got.shape == want.shape == (DIM // 2, DIM // 2)
        assert (want > 0).mean() > 0.7
        assert ((got > 0) == (want > 0)).mean() >= 0.995
        both = (got > 0) & (want > 0)
        close = np.abs(got[both] - want[both]) <= 1e-4 * np.abs(want[both])
        assert close.mean() >= 0.99


def test_cli_depth_embeddings_match_jax(runs):
    """By the optimizer bound of tests/test_torch_pipeline.py: the same
    mask, rtol 1.5e-3, fewer than 10% of pixels drifting by > 2e-4."""
    for want, got in zip(_embeddings(runs["jpath"], "smvs-B0"),
                         _embeddings(runs["tpath"], "smvs-B0")):
        assert got.shape == want.shape == (DIM, DIM)
        np.testing.assert_array_equal(got > 0, want > 0)
        m = want > 0
        assert m.mean() > 0.6
        np.testing.assert_allclose(got[m], want[m], rtol=1.5e-3)
        rel = np.abs(got[m] - want[m]) / np.abs(want[m])
        assert (rel > 2e-4).mean() < 0.1


def test_cli_point_clouds_match_jax(runs):
    want = load_ply(os.path.join(runs["jpath"], "smvs-B0.ply"))
    got = load_ply(os.path.join(runs["tpath"], "smvs-B0.ply"))
    assert len(want.vertices) > 1000
    assert abs(len(got.vertices) - len(want.vertices)) <= \
        0.01 * len(want.vertices)
    # and the fused points lie on the analytic plane (tests/test_cli.py)
    scene = runs["scene"]
    cam = scene.cameras[1]
    p_cam = got.vertices @ cam.rot.T + cam.trans
    uv = cam.project(p_cam, DIM, DIM)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < DIM) & (uv[:, 1] >= 0) & \
        (uv[:, 1] < DIM) & (p_cam[:, 2] > 0)
    gt = scene.depths[1][uv[inb, 1].astype(int), uv[inb, 0].astype(int)]
    rel = np.abs(p_cam[inb, 2] - gt) / gt
    assert np.median(rel) < 0.01


def test_cli_resume_skips_reconstructed_views(runs):
    path = str(runs["root"] / "resume")
    shutil.copytree(runs["tpath"], path)
    rc, out = _run(tcli.main, [path, "--device", "cpu", *ARGS])
    assert rc == 0
    assert "Skipping 4 views that are already reconstructed." in out


def test_cli_clean_removes_results(runs):
    path = str(runs["root"] / "clean")
    shutil.copytree(runs["tpath"], path)
    rc, out = _run(tcli.main, [path, "--device", "cpu", "--clean"])
    assert rc == 0 and "Cleaning scene" in out
    for names in (v.embedding_names() for v in jsc.Scene.load(path).views):
        assert names == ["undistorted"]


def test_cli_migrates_legacy_embeddings(runs):
    """Reference `app/smvsrecon.cc:429-452`: debug embeddings go, and
    `sgm-depth` becomes `smvs-sgm`. View 0 keeps its `smvs-B0`, so the run
    skips it and only migrates."""
    path = str(runs["root"] / "legacy")
    shutil.copytree(runs["tpath"], path)
    v = jsc.Scene.load(path).views[0]
    v.remove_embedding("smvs-sgm")
    fake = np.full((8, 8), 2.5, np.float32)
    v.set_image("sgm-depth", fake)
    v.set_image("lighting-shaded", np.zeros((8, 8), np.float32))
    v.save()
    rc, out = _run(tcli.main, [path, "--device", "cpu", "-r", "-l", "0",
                               *ARGS])
    assert rc == 0
    assert "Skipping 1 views that are already reconstructed." in out
    v2 = jsc.Scene.load(path).views[0]
    assert not v2.has_embedding("sgm-depth")
    assert not v2.has_embedding("lighting-shaded")
    np.testing.assert_array_equal(v2.get_image("smvs-sgm"), fake)


@pytest.mark.parametrize("flags", [["-d", "2"]])
def test_cli_unported_flags_raise(runs, flags):
    """`-d` above 1 (the debug image sinks) is not ported. Every other
    flag is: `-S` and `-R` below, `-g`, `--full-opt`, `-m`, `-y` and
    `--no-sgm` in tests/test_torch_cli_modes.py and
    tests/test_torch_cli_color.py."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcli.main([runs["tpath"], "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def shading_runs(runs):
    """Both CLIs with `-S` on copies of the scenes above (their `smvs-sgm`
    checkpoints are reused)."""
    jpath, tpath = (str(runs["root"] / f"shading_{k}") for k in ("j", "t"))
    shutil.copytree(runs["jpath"], jpath)
    shutil.copytree(runs["tpath"], tpath)
    jrc, _ = _run(jcli.main, [jpath, "--platform", "cpu", "--batch-views",
                              "1", "-S", *ARGS])
    trc, tout = _run(tcli.main, [tpath, "--device", "cpu", "-S", *ARGS])
    return dict(jpath=jpath, tpath=tpath, jrc=jrc, trc=trc, tout=tout)


def _fused(path, name, scene):
    """(points per pixel, median relative error of the fused points
    against view 1's analytic depth, as tests/test_cli.py reckons it)."""
    ps = load_ply(os.path.join(path, name))
    cam = scene.cameras[1]
    p_cam = ps.vertices @ cam.rot.T + cam.trans
    uv = cam.project(p_cam, DIM, DIM)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < DIM) & (uv[:, 1] >= 0) & \
        (uv[:, 1] < DIM) & (p_cam[:, 2] > 0)
    gt = scene.depths[1][uv[inb, 1].astype(int), uv[inb, 0].astype(int)]
    rel = np.abs(p_cam[inb, 2] - gt) / gt
    return len(ps.vertices) / (4 * DIM * DIM), float(np.median(rel))


def test_cli_shading_writes_smvs_s(shading_runs):
    """`-S` writes `smvs-S0` depth and normal embeddings and
    `smvs-S0.ply`, as the JAX CLI names them."""
    assert shading_runs["jrc"] == 0 and shading_runs["trc"] == 0
    assert "Output embedding: smvs-S0" in shading_runs["tout"]
    for v in range(4):
        vdir = os.path.join(shading_runs["tpath"], "views",
                            f"view_{v:04d}.mve")
        for name in ("smvs-S0", "smvs-S0N"):
            assert os.path.exists(os.path.join(vdir, name + ".mvei"))
    for path in (shading_runs["jpath"], shading_runs["tpath"]):
        assert os.path.exists(os.path.join(path, "smvs-S0.ply"))


def test_cli_shading_matches_jax_class(runs, shading_runs):
    """The fused points of `-S` in the JAX CLI's class on the same scene:
    points per pixel within 20% of JAX's, the median fused error at most
    twice JAX's or 1e-2 (the shading endpoint is chaotic, so not pixel by
    pixel)."""
    want = _fused(shading_runs["jpath"], "smvs-S0.ply", runs["scene"])
    got = _fused(shading_runs["tpath"], "smvs-S0.ply", runs["scene"])
    assert want[0] > 0.1, want
    assert abs(got[0] - want[0]) <= 0.2 * want[0], (got, want)
    assert got[1] <= max(2 * want[1], 1e-2), (got, want)


def test_cli_lighting_regularization_without_shading_equals_base(runs):
    """`-R` weights the regularizer under shading only: without `-S` the
    run equals the base run bit for bit."""
    out = {}
    for key, flags in (("base", []), ("R", ["-R", "0.5"])):
        path = str(runs["root"] / f"regularize_{key}")
        shutil.copytree(runs["tpath"], path)
        rc, _ = _run(tcli.main, [path, "--device", "cpu", "-f", *flags,
                                 *ARGS])
        assert rc == 0
        out[key] = (_embeddings(path, "smvs-B0"),
                    load_ply(os.path.join(path, "smvs-B0.ply")).vertices)
    for a, b in zip(out["R"][0], out["base"][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["R"][1], out["base"][1])


def test_cli_color_input_raises(tmp_path):
    """With SGM on, color views raise: the SGM init takes gray views only,
    as the JAX CLI's does (it fails in `reconstruct_sgm`); with
    `--no-sgm` they run (tests/test_torch_cli_color.py)."""
    scene = tsyn.make_plane_scene(n_views=2, dim=32)
    path = str(tmp_path / "color")
    tsyn.save_as_mve_scene(scene, path)
    loaded = jsc.Scene.load(path)
    rgb = np.repeat(np.asarray(loaded.views[0].get_image("undistorted"))
                    [..., None], 3, axis=-1)
    loaded.views[0].set_image("undistorted", rgb)
    loaded.views[0].save()
    with pytest.raises(NotImplementedError, match="color"):
        tcli.main([path, "--device", "cpu"])


def test_cli_needs_a_gpu_or_device_cpu(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([runs["tpath"]])
