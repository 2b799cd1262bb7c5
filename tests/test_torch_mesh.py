"""Triangle meshes (the CLI's `-m` and `-y`) and the simplify tool of the
port against the JAX package, on the CPU.

The port builds its own copy of the JAX package's C++ meshing library
(`smvs_tpu_torch/native`, g++ into `smvs_tpu_torch/_build`) and its own
copy of the numpy triangulation and merge, so on the same inputs every
output is bit-equal: Delaunay, the greedy triangulation, QEM
simplification, `full_triangulation`, `approximate_triangulation`,
`merge_meshes`, `fuse_views`' mesh branch and `tools.simplify`.

The greedy triangulation returns an empty mesh in both packages when all
four image corners are invalid, as in every depth map the optimizer
writes (its patch grid never reaches the corners); it is held here on
that input too, as behavior of the reference.
"""

import os
import time

import numpy as np
import pytest

from smvs_tpu import native as jnative
from smvs_tpu.mesh import pointcloud as jpc
from smvs_tpu.mesh import triangulate as jtri
from smvs_tpu.mesh.ply import load_ply
from smvs_tpu.tools import simplify as jsimplify
from smvs_tpu_torch import native as tnative
from smvs_tpu_torch.core import synthetic as tsyn
from smvs_tpu_torch.mesh import pointcloud as tpc
from smvs_tpu_torch.mesh import triangulate as ttri
from smvs_tpu_torch.mesh.ply import save_ply
from smvs_tpu_torch.tools import simplify as tsimplify


@pytest.fixture(autouse=True, scope="module")
def jax_native_built():
    """The JAX package builds its library with `make` into its own
    directory at first use; another test process may be writing it at that
    moment, so a load that finds a partial file is retried."""
    for attempt in range(5):
        try:
            jnative._load()
            return
        except OSError:
            if attempt == 4:
                raise
            time.sleep(3)


def _equal(got, want):
    for name in ("vertices", "faces", "colors", "normals", "values",
                 "confidences"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _depth(seed, dim=64, holes=True):
    """A bumpy slanted depth with a hole and a discontinuity."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:dim, 0:dim]
    d = 5.0 + 0.01 * x + 0.02 * y + 0.05 * np.sin(x / 5.0) * np.cos(y / 4.0)
    d += 0.001 * rng.standard_normal(d.shape)
    if holes:
        d[10:20, 30:45] = 0.0
        d[:, 50:] += 0.8
    return d.astype(np.float32)


def test_library_builds_into_the_port():
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert "smvs_tpu_torch" in path


def test_delaunay_bit_equal():
    pts = np.random.default_rng(0).uniform(0.0, 10.0, size=(60, 2))
    np.testing.assert_array_equal(tnative.delaunay(pts),
                                  jnative.delaunay(pts))
    np.testing.assert_array_equal(tnative.delaunay(pts, (-1, -1, 11, 11)),
                                  jnative.delaunay(pts, (-1, -1, 11, 11)))


@pytest.mark.parametrize("case", ["full", "holes", "corners"])
def test_native_approximate_triangulation_bit_equal(case):
    d = _depth(1, holes=case != "full")
    if case == "corners":  # the optimizer's maps: no depth at the corners
        d[:2], d[-2:], d[:, :2], d[:, -2:] = 0, 0, 0, 0
    gv, gf = tnative.approximate_triangulation(d)
    wv, wf = jnative.approximate_triangulation(d)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)
    if case == "corners":
        assert len(wf) == 0  # the reference's behavior, see above
    else:
        assert len(wf) > 10


def test_native_simplify_bit_equal():
    cam = tsyn.make_plane_scene(n_views=2, dim=64).cameras[0]
    mesh = ttri.full_triangulation(_depth(2, holes=False), cam)
    for ratio in (0.25, 0.5):
        gv, gf = tnative.simplify_mesh(mesh.vertices, mesh.faces, ratio)
        wv, wf = jnative.simplify_mesh(mesh.vertices, mesh.faces, ratio)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)
        assert len(gf) <= ratio * len(mesh.faces) + 2


@pytest.mark.parametrize("color", [None, "gray", "rgb"])
def test_full_triangulation_bit_equal(color):
    scene = tsyn.make_plane_scene(n_views=2, dim=64, color=color == "rgb")
    img = scene.images[0] if color else None
    if color == "gray":
        img = img[..., 0] if img.ndim == 3 else img
    d = _depth(3)
    got = ttri.full_triangulation(d, scene.cameras[0], color=img)
    want = jtri.full_triangulation(d, scene.cameras[0], color=img)
    _equal(got, want)
    assert len(want.faces) > 1000


def test_approximate_triangulation_and_merge_bit_equal():
    scene = tsyn.make_plane_scene(n_views=2, dim=64)
    meshes = {}
    for k, tri in (("t", ttri), ("j", jtri)):
        parts = [tri.approximate_triangulation(_depth(4 + i),
                                               scene.cameras[i])
                 for i in range(2)]
        parts.append(tri.full_triangulation(_depth(6), scene.cameras[1]))
        meshes[k] = (parts, tri.merge_meshes(parts))
    for g, w in zip(meshes["t"][0], meshes["j"][0]):
        _equal(g, w)
    _equal(meshes["t"][1], meshes["j"][1])
    assert len(meshes["j"][1].faces) > len(meshes["j"][0][2].faces)


@pytest.mark.parametrize("simplify", [False, True])
def test_fuse_views_mesh_bit_equal(simplify):
    """`fuse_views` with `create_triangle_mesh` (and `simplify`): the cut
    depth maps triangulated and merged."""
    scene = tsyn.make_plane_scene(n_views=3, dim=64, color=True)
    depths = [d.astype(np.float32) for d in scene.depths]
    normals = [np.broadcast_to(np.float32([0, 0, 1]), d.shape + (3,))
               for d in depths]
    args = (depths, normals, scene.cameras, scene.images)
    got = tpc.fuse_views(*args, tpc.FusionOptions(
        create_triangle_mesh=True, simplify=simplify))
    want = jpc.fuse_views(*args, jpc.FusionOptions(
        create_triangle_mesh=True, simplify=simplify))
    _equal(got, want)
    assert len(want.faces) > 0


def test_simplify_tool_bit_equal(tmp_path, capsys):
    cam = tsyn.make_plane_scene(n_views=2, dim=64).cameras[0]
    src = str(tmp_path / "in.ply")
    save_ply(src, ttri.full_triangulation(_depth(7), cam))
    outs = {k: str(tmp_path / f"{k}.ply") for k in "tj"}
    assert tsimplify.main([src, outs["t"], "0.3"]) == 0
    assert jsimplify.main([src, outs["j"], "0.3"]) == 0
    got, want = load_ply(outs["t"]), load_ply(outs["j"])
    _equal(got, want)
    assert 0 < len(got.faces) <= 0.3 * len(load_ply(src).faces) + 2
    assert tsimplify.main([src]) == 2
