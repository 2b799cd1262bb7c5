"""The port's host-side scene stages against the JAX package, on the CPU:
MVE scene IO (both directions), camera helpers, synthetic scenes, view
selection, the CLI's rescales, fusion and PLY output."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import camera as jcam
from smvs_tpu.core import scene as jsc
from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.image import ops as jops
from smvs_tpu.mesh import pointcloud as jpc
from smvs_tpu.mesh import ply as jply
from smvs_tpu.pipeline import view_selection as jvs
from smvs_tpu_torch.core import camera as tcam
from smvs_tpu_torch.core import scene as tsc
from smvs_tpu_torch.core import synthetic as tsyn
from smvs_tpu_torch.image import ops as tops
from smvs_tpu_torch.mesh import pointcloud as tpc
from smvs_tpu_torch.mesh import ply as tply
from smvs_tpu_torch.pipeline import view_selection as tvs
from torch_threads import one_torch_thread  # noqa: F401


def _cameras(mod, n=5, seed=0):
    rng = np.random.default_rng(seed)
    cams = []
    for _ in range(n):
        u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)) * 0.05 + np.eye(3))
        cams.append(mod.Camera(flen=float(rng.uniform(0.8, 1.4)),
                               rot=u @ vt, trans=rng.normal(size=3) * 0.3,
                               ppoint=(0.49, 0.51), paspect=1.0))
    return cams


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16,
                                   np.int32])
def test_mvei_round_trips_between_packages(tmp_path, dtype):
    rng = np.random.default_rng(1)
    img = (rng.random((7, 9, 3)) * 100).astype(dtype)
    tsc.save_mvei(str(tmp_path / "t.mvei"), img)
    jsc.save_mvei(str(tmp_path / "j.mvei"), img)
    assert (tmp_path / "t.mvei").read_bytes() == \
        (tmp_path / "j.mvei").read_bytes()
    np.testing.assert_array_equal(jsc.load_mvei(str(tmp_path / "t.mvei")),
                                  img)
    np.testing.assert_array_equal(tsc.load_mvei(str(tmp_path / "j.mvei")),
                                  img)


def test_scene_written_by_either_package_loads_in_the_other(tmp_path):
    """Same synthetic scene saved by both packages: the same files, byte
    for byte, and each loads the other's views, embeddings and bundle."""
    js = jsyn.make_plane_scene(n_views=3, dim=40)
    ts = tsyn.make_plane_scene(n_views=3, dim=40)
    for a, b in zip(js.images, ts.images):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(js.depths, ts.depths):
        np.testing.assert_array_equal(a, b)
    jsyn.save_as_mve_scene(js, str(tmp_path / "j"))
    tsyn.save_as_mve_scene(ts, str(tmp_path / "t"))
    assert _files(tmp_path / "j") == _files(tmp_path / "t")

    depth = np.random.default_rng(2).random((40, 40)).astype(np.float32)
    tscene = tsc.Scene.load(str(tmp_path / "j"))
    tscene.views[1].set_image("smvs-B0", depth)
    tscene.views[1].save()
    jscene = jsc.Scene.load(str(tmp_path / "j"))
    np.testing.assert_array_equal(jscene.views[1].get_image("smvs-B0"),
                                  depth)
    for tv, jv in zip(tscene.views, jscene.views):
        assert (tv.view_id, tv.name) == (jv.view_id, jv.name)
        np.testing.assert_array_equal(tv.camera.rot, jv.camera.rot)
        np.testing.assert_array_equal(tv.camera.trans, jv.camera.trans)
        assert tv.embedding_names() == jv.embedding_names()
        np.testing.assert_array_equal(tv.get_image("undistorted"),
                                      jv.get_image("undistorted"))
    assert len(tscene.bundle.features) == len(jscene.bundle.features)
    for tf, jf in zip(tscene.bundle.features, jscene.bundle.features):
        np.testing.assert_array_equal(tf.pos, jf.pos)
        assert tf.refs == jf.refs

    jscene.clean_embeddings()
    assert not tsc.Scene.load(str(tmp_path / "j")).views[1].has_embedding(
        "smvs-B0")


def test_legacy_view_container_loads(tmp_path):
    """A legacy single-file `.mve` view written by the JAX package loads
    in the port and upgrades to the directory layout on save."""
    v = jsc.View(view_id=3, name="legacy", camera=_cameras(jcam, 1)[0])
    v.set_image("undistorted", np.arange(30, dtype=np.uint8).reshape(5, 6))
    path = str(tmp_path / "view_0003.mve")
    jsc.save_legacy_mve(v, path)
    t = tsc.View.load_legacy(path)
    assert (t.view_id, t.name) == (3, "legacy")
    np.testing.assert_array_equal(t.camera.rot, v.camera.rot)
    np.testing.assert_array_equal(t.get_image("undistorted"),
                                  v.get_image("undistorted"))
    t.save()
    assert os.path.isdir(path) and os.path.isfile(path + ".orig")
    np.testing.assert_array_equal(
        jsc.View.load(path).get_image("undistorted"),
        v.get_image("undistorted"))


def test_bundle_queries_match():
    cams_j, cams_t = _cameras(jcam), _cameras(tcam)
    rng = np.random.default_rng(3)
    feats_j, feats_t = [], []
    for _ in range(60):
        pos = rng.normal(size=3) * 0.6 + np.array([0.0, 0.0, 5.0])
        refs = sorted(rng.choice(5, size=3, replace=False).tolist())
        feats_j.append(jsc.Feature3D(pos=pos, color=np.zeros(3), refs=refs))
        feats_t.append(tsc.Feature3D(pos=pos, color=np.zeros(3), refs=refs))
    bj = jsc.Bundle(cameras=cams_j, features=feats_j)
    bt = tsc.Bundle(cameras=cams_t, features=feats_t)
    for v in range(5):
        np.testing.assert_array_equal(
            bt.feature_depths_for_view(v, cams_t[v], 64, 48),
            bj.feature_depths_for_view(v, cams_j[v], 64, 48))
        np.testing.assert_array_equal(
            bt.splat_depth_map(v, cams_t[v], 64, 48),
            bj.splat_depth_map(v, cams_j[v], 64, 48))


def test_camera_helpers_match():
    cj, ct = _cameras(jcam, 1, seed=4)[0], _cameras(tcam, 1, seed=4)[0]
    pts = np.random.default_rng(5).normal(size=(20, 3)) + [0, 0, 4.0]
    np.testing.assert_array_equal(ct.world_to_cam(pts), cj.world_to_cam(pts))
    pc = cj.world_to_cam(pts)
    np.testing.assert_array_equal(ct.project(pc, 70, 50),
                                  cj.project(pc, 70, 50))
    rj = cj.resized_canvas(1437, 1080, 1440, 1088)
    rt = ct.resized_canvas(1437, 1080, 1440, 1088)
    np.testing.assert_array_equal(rt.calibration(1440, 1088),
                                  rj.calibration(1440, 1088))
    np.testing.assert_allclose(rt.calibration(1440, 1088),
                               ct.calibration(1437, 1080), rtol=1e-12)
    depth = np.random.default_rng(6).uniform(0, 8, (30, 40))
    depth[depth < 2] = 0
    inv = ct.inverse_calibration(40, 30)
    mve = tcam.depth_z_to_mve(depth, inv)
    np.testing.assert_array_equal(mve, jcam.depth_z_to_mve(depth, inv))
    back = tcam.depth_mve_to_z(mve, inv)
    np.testing.assert_array_equal(back, jcam.depth_mve_to_z(mve, inv))
    np.testing.assert_allclose(back, depth, rtol=1e-14)


def test_view_selection_returns_the_same_lists():
    js = jsyn.make_plane_scene(n_views=5, dim=48)
    ts = tsyn.make_plane_scene(n_views=5, dim=48)
    rng = np.random.default_rng(7)
    pos = [rng.normal(size=3) * 0.5 + [0, 0, 5.0] for _ in range(80)]
    refs = [sorted(rng.choice(5, size=int(rng.integers(2, 6)),
                              replace=False).tolist()) for _ in range(80)]
    bj = jsc.Bundle(js.cameras, [jsc.Feature3D(p, np.zeros(3), r)
                                 for p, r in zip(pos, refs)])
    bt = tsc.Bundle(ts.cameras, [tsc.Feature3D(p, np.zeros(3), r)
                                 for p, r in zip(pos, refs)])
    sizes = [(48, 48)] * 5
    for v in range(5):
        for n in (2, 6):
            got = tvs.get_neighbors_for_view(
                ts.cameras, sizes, bt, v, tvs.ViewSelectionOptions(n))
            assert got == jvs.get_neighbors_for_view(
                js.cameras, sizes, bj, v, jvs.ViewSelectionOptions(n))
            assert tvs.get_neighbors_for_view(
                ts.cameras, sizes, None, v, tvs.ViewSelectionOptions(n)) == \
                jvs.get_neighbors_for_view(js.cameras, sizes, None, v,
                                           jvs.ViewSelectionOptions(n))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Units in the last place between two positive float32 arrays."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("shape", [(80, 80), (66, 96), (3, 34, 36),
                                   (33, 35), (64, 64), (128, 128),
                                   (16, 1024)])
def test_rescales_match(shape):
    """The input rescale is within an ulp. The SGM-scale box rescale sums
    each 2x2 block in order, as XLA's CPU code does except at power-of-two
    output widths (and some odd sizes), where it sums pairwise: there
    about a fifth of the pixels differ, by at most 2 ulp (the effect on
    SGM: tests/test_torch_general.py)."""
    rng = np.random.default_rng(8)
    img = rng.random(shape).astype(np.float32)
    want = np.asarray(jops.rescale_half_size_gaussian(jnp.asarray(img)))
    got = tops.rescale_half_size_gaussian(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    img255 = img * np.float32(255.0)
    got = tops.rescale_half_size(torch.from_numpy(img255)).numpy()
    want = np.asarray(jops.rescale_half_size(jnp.asarray(img255)))
    ulps = _ulps(got, want)
    assert ulps.max() <= 2
    ow = shape[-1] // 2
    if shape[-1] % 2 == 0 and ow & (ow - 1):
        assert ulps.max() == 0
    elif shape[-1] % 2 == 0:
        assert 0.1 < (ulps > 0).mean() < 0.35


def _fusion_inputs(n=3, dim=48):
    js = jsyn.make_plane_scene(n_views=n, dim=dim)
    ts = tsyn.make_plane_scene(n_views=n, dim=dim)
    rng = np.random.default_rng(9)
    depths, normals, colors = [], [], []
    for d in ts.depths:
        dd = d * rng.uniform(0.995, 1.005, d.shape)
        dd[rng.random(d.shape) < 0.1] = 0.0
        depths.append(dd)
        nrm = rng.normal(size=d.shape + (3,)) * 0.1 + [0.0, 0.0, 1.0]
        normals.append((nrm / np.linalg.norm(nrm, axis=-1,
                                             keepdims=True)).astype(
                                                 np.float32))
        colors.append(rng.random(d.shape).astype(np.float32))
    return js.cameras, ts.cameras, depths, normals, colors


@pytest.mark.parametrize("cut", [True, False])
def test_fuse_views_and_ply_bytes_match(tmp_path, cut):
    jcams, tcams, depths, normals, colors = _fusion_inputs()
    want = jpc.fuse_views(depths, normals, jcams, colors,
                          jpc.FusionOptions(cut_surfaces=cut))
    got = tpc.fuse_views(depths, normals, tcams, colors,
                         tpc.FusionOptions(cut_surfaces=cut))
    for name in ("vertices", "normals", "colors", "values", "confidences"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    if cut:
        assert len(got.vertices) < sum(int((d > 0).sum()) for d in depths)
    tply.save_ply(str(tmp_path / "t.ply"), got)
    jply.save_ply(str(tmp_path / "j.ply"), want)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    back = tply.load_ply(str(tmp_path / "j.ply"))
    np.testing.assert_array_equal(back.vertices, want.vertices)
    lo, hi = [-1.0, -1.0, 4.0], [1.0, 1.0, 6.0]
    clipped = tpc.clip_aabb(got, lo, hi)
    ref = jpc.clip_aabb(want, lo, hi)
    assert 0 < len(clipped.vertices) < len(got.vertices)
    np.testing.assert_array_equal(clipped.vertices, ref.vertices)
    np.testing.assert_array_equal(clipped.confidences, ref.confidences)
