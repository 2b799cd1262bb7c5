"""The port's CLI modes on gray views against the JAX CLI, end to end on
the CPU, on the 4-view plane scene of tests/test_torch_cli.py with `-o 3`:

- `--full-opt -m` (every node active in every Newton step, a triangle
  mesh per view), then `-m -y` in the same directory, which skips the
  reconstructed views and only fuses them into greedy simplified meshes;
- `-S -g` (the shading-aware optimizer on the sRGB-decoded image), then
  `-m` in the same directory (base mode from the checkpointed SGM depth,
  fused into a mesh).

The greedy triangulation of `-y` returns an empty mesh in both packages
on the optimizer's depth maps, whose corners are never reconstructed
(tests/test_torch_mesh.py); the port reproduces that.
"""

import contextlib
import io
import os
import shutil

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


def _both(paths, flags, keep=None):
    """Both CLIs with ``flags``; ``keep`` copies that PLY aside as
    `kept.ply` (a later run in the directory overwrites it)."""
    res = {}
    for k, argv in (("jax", ["--platform", "cpu", "--batch-views", "1"]),
                    ("port", ["--device", "cpu"])):
        main = jcli.main if k == "jax" else tcli.main
        res[k] = _run(main, [paths[k], *argv, *flags, *ARGS])
        if keep:
            shutil.copy(os.path.join(paths[k], keep),
                        os.path.join(paths[k], "kept.ply"))
    return res


@pytest.fixture(scope="module")
def scene():
    return tsyn.make_plane_scene(n_views=4, dim=DIM)


def _dirs(root, scene):
    paths = {k: str(root / k) for k in ("jax", "port")}
    for path in paths.values():
        tsyn.save_as_mve_scene(scene, path)
    return paths


@pytest.fixture(scope="module")
def full_opt(tmp_path_factory, scene):
    paths = _dirs(tmp_path_factory.mktemp("cli_full_opt"), scene)
    first = _both(paths, ["--full-opt", "-m"], keep="smvs-m-B0.ply")
    second = _both(paths, ["-m", "-y"])
    return dict(paths=paths, first=first, second=second)


@pytest.fixture(scope="module")
def shading_then_mesh(tmp_path_factory, scene):
    paths = _dirs(tmp_path_factory.mktemp("cli_srgb"), scene)
    shading = _both(paths, ["-S", "-g"])
    mesh = _both(paths, ["-m"])
    return dict(paths=paths, shading=shading, mesh=mesh)


def _embeddings(path, name):
    return [np.asarray(v.get_image(name))
            for v in jsc.Scene.load(path).views]


def _fused_error(ps, scene):
    """Median relative error of the points against view 1's analytic
    depth (as tests/test_cli.py reckons it)."""
    cam = scene.cameras[1]
    p_cam = ps.vertices @ cam.rot.T + cam.trans
    uv = cam.project(p_cam, DIM, DIM)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < DIM) & (uv[:, 1] >= 0) & \
        (uv[:, 1] < DIM) & (p_cam[:, 2] > 0)
    gt = scene.depths[1][uv[inb, 1].astype(int), uv[inb, 0].astype(int)]
    return float(np.median(np.abs(p_cam[inb, 2] - gt) / gt))


def _rcs(res):
    return [r[0] for r in res.values()]


def test_cli_full_opt_depths_match_jax(full_opt):
    """`--full-opt` by the optimizer bar: the same mask, rtol 1.5e-3,
    fewer than 10% of pixels drifting by > 2e-4."""
    assert _rcs(full_opt["first"]) == [0, 0]
    for want, got in zip(_embeddings(full_opt["paths"]["jax"], "smvs-B0"),
                         _embeddings(full_opt["paths"]["port"], "smvs-B0")):
        assert got.shape == want.shape == (DIM, DIM)
        np.testing.assert_array_equal(got > 0, want > 0)
        m = want > 0
        assert m.mean() > 0.6
        np.testing.assert_allclose(got[m], want[m], rtol=1.5e-3)
        rel = np.abs(got[m] - want[m]) / np.abs(want[m])
        assert (rel > 2e-4).mean() < 0.1


def _meshes(paths, name):
    return [load_ply(os.path.join(paths[k], name)) for k in ("jax", "port")]


def test_cli_full_opt_mesh_matches_jax(full_opt, scene):
    """`-m` writes `smvs-m-B0.ply`: vertices and faces within 1% of the
    JAX CLI's, faces indexing its vertices, on the analytic plane."""
    want, got = _meshes(full_opt["paths"], "kept.ply")
    assert len(want.faces) > len(want.vertices) > 1000
    for a, b in ((got.vertices, want.vertices), (got.faces, want.faces)):
        assert abs(len(a) - len(b)) <= 0.01 * len(b)
    assert got.faces.min() == 0 and got.faces.max() == len(got.vertices) - 1
    assert _fused_error(got, scene) < 0.01
    assert "Saved " in full_opt["first"]["port"][1]


def test_cli_simplified_mesh_matches_jax(full_opt):
    """`-m -y` on the reconstructed directory: both CLIs skip every view
    and fuse; the simplified meshes are equal (empty in both: the greedy
    triangulation of a map without depth at the image corners) and have
    fewer faces than the full ones."""
    assert _rcs(full_opt["second"]) == [0, 0]
    out = full_opt["second"]["port"][1]
    assert "Skipping 4 views that are already reconstructed." in out
    want, got = _meshes(full_opt["paths"], "smvs-m-B0.ply")
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert len(got.vertices) == len(want.vertices) == 0
    full = _meshes(full_opt["paths"], "kept.ply")[1]
    assert (0 if got.faces is None else len(got.faces)) < len(full.faces)


def test_cli_gray_shading_srgb_matches_jax_class(shading_then_mesh, scene):
    """`-S -g` on gray views: the class of tests/test_torch_cli.py (the
    shading endpoint is chaotic): points within 20% of JAX's, median
    fused error at most twice JAX's or 1e-2."""
    assert _rcs(shading_then_mesh["shading"]) == [0, 0]
    want, got = _meshes(shading_then_mesh["paths"], "smvs-S0.ply")
    assert len(want.vertices) > 0.1 * 4 * DIM * DIM
    assert abs(len(got.vertices) - len(want.vertices)) <= \
        0.2 * len(want.vertices)
    assert _fused_error(got, scene) <= max(2 * _fused_error(want, scene),
                                           1e-2)


def test_cli_base_mesh_matches_jax(shading_then_mesh, scene):
    """`-m` in base mode after `-S`: reconstructs `smvs-B0` from the
    checkpointed SGM depth and meshes it; vertices and faces within 1% of
    the JAX CLI's, gray vertex colors."""
    assert _rcs(shading_then_mesh["mesh"]) == [0, 0]
    out = shading_then_mesh["mesh"]["port"][1]
    assert "Output embedding: smvs-B0" in out and "Skipping" not in out
    want, got = _meshes(shading_then_mesh["paths"], "smvs-m-B0.ply")
    assert len(want.faces) > len(want.vertices) > 1000
    for a, b in ((got.vertices, want.vertices), (got.faces, want.faces)):
        assert abs(len(a) - len(b)) <= 0.01 * len(b)
    assert (got.colors[:, 0] == got.colors[:, 2]).all()
    assert _fused_error(got, scene) < 0.01
