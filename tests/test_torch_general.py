"""The port's general-warp SGM and multi-neighbor SGM against the JAX
package, on the CPU.

The general path's warp matrices enter as float32 on both sides here (as
the JAX package runs them without x64); the cost volume then matches bit
for bit, because the port rounds the warp and the bilinear blends the way
XLA fuses them into multiply-adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.core.camera import Camera as JCamera
from smvs_tpu.image import ops as jops
from smvs_tpu.sgm import stereo as jst
from smvs_tpu_torch.core import synthetic as tsyn
from smvs_tpu_torch.image import ops as tops
from smvs_tpu_torch.sgm import rectify as trect
from smvs_tpu_torch.sgm import stereo as tst
from torch_threads import one_torch_thread  # noqa: F401


def _f32(*arrays):
    return [np.asarray(a, np.float32) for a in arrays]


@pytest.fixture(scope="module")
def pair96():
    """The scene of tests/test_sgm.py's general-path test, at dim 96."""
    dim = 96
    scene = jsyn.make_two_view_scene(dim=dim, rotate=False, baseline=0.25,
                                     texture="noise")
    cm, cn = scene.cameras[1], scene.cameras[0]
    M_mn, t_mn = cm.fill_reprojection(cn, dim, dim, dim, dim)
    M_nm, t_nm = cn.fill_reprojection(cm, dim, dim, dim, dim)
    return dict(scene=scene, main=scene.images[1] * np.float32(255.0),
                nbr=scene.images[0] * np.float32(255.0),
                mats=_f32(M_mn, t_mn, M_nm, t_nm))


def _close_depths(got, want):
    """The `reconstruct_auto` tolerance (tests/test_torch_sgm.py): masks
    agree on >= 99.5% of pixels, >= 99% of pixels valid in both agree to
    rtol 1e-4."""
    assert got.shape == want.shape and got.dtype == np.float32
    assert ((got > 0) == (want > 0)).mean() >= 0.995
    both = (got > 0) & (want > 0)
    close = np.abs(got[both] - want[both]) <= 1e-4 * np.abs(want[both])
    assert close.mean() >= 0.99


def test_cost_volume_bit_exact(pair96):
    main, nbr = pair96["main"], pair96["nbr"]
    M, t = pair96["mats"][:2]
    depths = jst.depth_planes(4.0, 8.5, 40)
    want = np.asarray(jst.cost_volume(jnp.asarray(main), jnp.asarray(nbr),
                                      jnp.asarray(M), jnp.asarray(t),
                                      jnp.asarray(depths)))
    got = tst.cost_volume(*[torch.from_numpy(a)
                            for a in (main, nbr, M, t, depths)])
    assert got.dtype == torch.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_cost_volume_bit_exact_rotated_forward_pair():
    """A rotated camera moving mostly forward: every warp coefficient is
    non-zero, so every fused multiply-add of the warp is exercised."""
    scene = jsyn.make_two_view_scene(dim=64, rotate=True, texture="noise")
    from smvs_tpu.core.camera import Camera

    cam = Camera(flen=1.0, rot=scene.cameras[1].rot,
                 trans=np.array([0.05, 0.02, -0.4]))
    M, t = _f32(*cam.fill_reprojection(scene.cameras[0], 64, 64, 64, 64))
    main = scene.images[1] * np.float32(255.0)
    nbr = scene.images[0] * np.float32(255.0)
    depths = jst.depth_planes(3.0, 9.0, 24)
    want = np.asarray(jst.cost_volume(jnp.asarray(main), jnp.asarray(nbr),
                                      jnp.asarray(M), jnp.asarray(t),
                                      jnp.asarray(depths)))
    got = tst.cost_volume(*[torch.from_numpy(a)
                            for a in (main, nbr, M, t, depths)])
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_winner_take_all_matches():
    rng = np.random.default_rng(20)
    agg = rng.integers(0, 40, size=(9, 11, 16)).astype(np.int16)  # ties
    inten = rng.uniform(0, 255, size=(9, 11)).astype(np.float32)
    depths = jst.depth_planes(2.0, 7.0, 16)
    want = np.asarray(jst.winner_take_all(jnp.asarray(agg),
                                          jnp.asarray(inten),
                                          jnp.asarray(depths)))
    got = tst.winner_take_all(*[torch.from_numpy(a)
                                for a in (agg, inten, depths)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_consistency_filter_matches(pair96):
    """Integer-coordinate warp and truncation, as the reference does."""
    rng = np.random.default_rng(21)
    gt = pair96["scene"].depths[1].astype(np.float32)
    d_main = np.where(rng.random(gt.shape) < 0.8,
                      gt * rng.uniform(0.85, 1.15, gt.shape), 0.0)
    d_neig = np.where(rng.random(gt.shape) < 0.8,
                      gt * rng.uniform(0.85, 1.15, gt.shape), 0.0)
    d_main, d_neig = _f32(d_main, d_neig)
    M, t = pair96["mats"][:2]
    want = np.asarray(jst.consistency_filter(
        jnp.asarray(d_main), jnp.asarray(d_neig), jnp.asarray(M),
        jnp.asarray(t)))
    got = tst.consistency_filter(*[torch.from_numpy(a)
                                   for a in (d_main, d_neig, M, t)]).numpy()
    assert 0.2 < (want > 0).mean() < (d_main > 0).mean()
    np.testing.assert_array_equal(got, want)


def test_reconstruct_matches_jax_dim96(pair96):
    main, nbr = pair96["main"], pair96["nbr"]
    opts = tst.SGMOptions(num_steps=96)
    want = np.asarray(jst.reconstruct(
        jnp.asarray(main), jnp.asarray(nbr),
        *[jnp.asarray(a) for a in pair96["mats"]], (4.0, 8.5), (4.0, 8.5),
        jst.SGMOptions(num_steps=96)))
    got = tst.reconstruct(torch.from_numpy(main), torch.from_numpy(nbr),
                          *[torch.from_numpy(a) for a in pair96["mats"]],
                          (4.0, 8.5), (4.0, 8.5), opts).numpy()
    assert (want > 0).mean() > 0.8
    _close_depths(got, want)
    gt = pair96["scene"].depths[1]
    m = got > 0
    assert np.median(np.abs(got[m] - gt[m]) / gt[m]) < 0.03


def test_depth_range_from_features_matches():
    rng = np.random.default_rng(22)
    for n in (0, 1, 2, 57):
        d = rng.uniform(2.0, 9.0, n)
        assert tst.depth_range_from_features(d) == \
            jst.depth_range_from_features(d)


def _plane_views(dim):
    """The JAX package's and the port's cameras of one plane scene, and
    its images on the 0..255 scale."""
    jscene = jsyn.make_plane_scene(n_views=3, dim=dim)
    tscene = tsyn.make_plane_scene(n_views=3, dim=dim)
    return (jscene.cameras, tscene.cameras,
            [im * np.float32(255.0) for im in tscene.images])


def test_reconstruct_auto_multi_fused_branch_matches():
    """Every pair rectifies and shares the main shape: the JAX package's
    fused branch, one program on the widest pair's canvas, which the
    port's loop over pairs matches by sharing that canvas."""
    jcams, cams, imgs = _plane_views(64)
    rng = (4.0, 6.5)
    for c in (cams[0], cams[2]):
        assert trect.rectify_pair(cams[1], c, 64, 64, rng, rng).valid
    want = np.asarray(jst.reconstruct_auto_multi(
        jcams[1], [jcams[0], jcams[2]], jnp.asarray(imgs[1]),
        [jnp.asarray(imgs[0]), jnp.asarray(imgs[2])], rng, [rng, rng]))
    got = tst.reconstruct_auto_multi(
        cams[1], [cams[0], cams[2]], torch.from_numpy(imgs[1]),
        [torch.from_numpy(imgs[0]), torch.from_numpy(imgs[2])], rng,
        [rng, rng], device="cpu").numpy()
    assert (want > 0).mean() > 0.5
    _close_depths(got, want)


def test_reconstruct_auto_multi_sequential_branch_matches():
    """One neighbor image of another shape: the JAX package's sequential
    branch, each pair on its own canvas, averaged on the host."""
    jcams, cams, imgs = _plane_views(64)
    small = imgs[2][:, :60].copy()
    cam_small = cams[2].resized_canvas(64, 64, 60, 64)
    jcam_small = jcams[2].resized_canvas(64, 64, 60, 64)
    rng = (4.0, 6.5)
    want = np.asarray(jst.reconstruct_auto_multi(
        jcams[1], [jcams[0], jcam_small], jnp.asarray(imgs[1]),
        [jnp.asarray(imgs[0]), jnp.asarray(small)], rng, [rng, rng]))
    got = tst.reconstruct_auto_multi(
        cams[1], [cams[0], cam_small], torch.from_numpy(imgs[1]),
        [torch.from_numpy(imgs[0]), torch.from_numpy(small)], rng,
        [rng, rng], device="cpu").numpy()
    assert (want > 0).mean() > 0.5
    _close_depths(got, want)


def test_reconstruct_auto_multi_forward_motion_takes_general_path():
    """The plane seen by views moving toward it: no pair rectifies, so the
    JAX package's sequential branch runs the general-warp fallback for
    each pair, and so does the port (as the CLI reaches it)."""
    dim, rng = 64, (3.0, 6.5)
    cams = tsyn.forward_cameras()
    jcams = [JCamera(flen=c.flen, rot=c.rot, trans=c.trans) for c in cams]
    scene = tsyn.make_plane_scene(dim=dim, cameras=cams)
    imgs = [im * np.float32(255.0) for im in scene.images]
    for c in (cams[1], cams[2]):
        assert not trect.rectify_pair(cams[0], c, dim, dim, rng, rng).valid
    want = np.asarray(jst.reconstruct_auto_multi(
        jcams[0], [jcams[1], jcams[2]], jnp.asarray(imgs[0]),
        [jnp.asarray(imgs[1]), jnp.asarray(imgs[2])], rng, [rng, rng]))
    got = tst.reconstruct_auto_multi(
        cams[0], [cams[1], cams[2]], torch.from_numpy(imgs[0]),
        [torch.from_numpy(imgs[1]), torch.from_numpy(imgs[2])], rng,
        [rng, rng], device="cpu").numpy()
    assert (want > 0).mean() > 0.5
    _close_depths(got, want)
    m = got > 0
    gt = scene.depths[0]
    assert np.median(np.abs(got[m] - gt[m]) / gt[m]) < 0.01


def test_sgm_after_each_packages_power_of_two_rescale():
    """The CLI's SGM-scale rescale at a power-of-two width (128 -> 64 px),
    where XLA's CPU code sums the 2x2 blocks pairwise and the port in
    order (tests/test_torch_scene.py): each package rescales its own
    input, so about a fifth of the SGM input pixels differ by an ulp or
    two. The census turns a few into other costs; the depth maps still
    meet the `reconstruct_auto` tolerance (on the CPU 0.36% of the pixels
    valid in both differ by more than 1e-4; the bound is 1%), and from the
    same inputs none does."""
    jcams, cams, imgs = _plane_views(128)
    rng = (4.0, 6.5)
    jin = [jops.rescale_half_size(jnp.asarray(im)) for im in imgs]
    tin = [tops.rescale_half_size(torch.from_numpy(im)) for im in imgs]
    assert 0.1 < np.mean([(np.asarray(a) != b.numpy()).mean()
                          for a, b in zip(jin, tin)]) < 0.35
    want = np.asarray(jst.reconstruct_auto_multi(
        jcams[1], [jcams[0], jcams[2]], jin[1], [jin[0], jin[2]], rng,
        [rng, rng]))
    got = tst.reconstruct_auto_multi(cams[1], [cams[0], cams[2]], tin[1],
                                     [tin[0], tin[2]], rng, [rng, rng],
                                     device="cpu").numpy()
    assert (want > 0).mean() > 0.9
    _close_depths(got, want)
    # From the JAX package's inputs, no pixel is more than 1e-4 apart.
    same = tst.reconstruct_auto_multi(
        cams[1], [cams[0], cams[2]], torch.from_numpy(np.asarray(jin[1])),
        [torch.from_numpy(np.asarray(jin[k])) for k in (0, 2)], rng,
        [rng, rng], device="cpu").numpy()
    both = (same > 0) & (want > 0)
    np.testing.assert_array_equal(same > 0, want > 0)
    np.testing.assert_allclose(same[both], want[both], rtol=1e-4)
