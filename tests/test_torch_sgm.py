"""The port's rectified SGM path against the JAX package, on the CPU, and
the routing of a pair that does not rectify to the general-warp path.

Integer stages (census, Hamming, cost volume, aggregation, WTA index) must
match bit for bit. The aggregation's plain twin is held against both the
`lax.scan` reference and the Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.sgm import pallas_agg
from smvs_tpu.sgm import rectify as jrect
from smvs_tpu.sgm import stereo as jst
from smvs_tpu_torch.core import synthetic as tsyn
from smvs_tpu_torch.sgm import cuda_agg
from smvs_tpu_torch.sgm import rectify as trect
from smvs_tpu_torch.sgm import stereo as tst
from torch_threads import one_torch_thread  # noqa: F401


def _image(h, w, seed, levels=8, zero_frac=0.05):
    """Small-integer intensities (many census ties) with a few holes."""
    rng = np.random.default_rng(seed)
    img = rng.integers(1, levels, size=(h, w)).astype(np.float32) * 30.0
    img[rng.random((h, w)) < zero_frac] = 0.0
    return img


def _volume(b, h, w, d, seed, hi=127):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, hi, size=(b, h, w, d)).astype(np.int16)
    inten = rng.integers(0, 255, size=(b, h, w)).astype(np.int32)
    return cost, inten


def test_census_word_equals_jax_hi_lo():
    img = _image(17, 23, seed=0)
    hi, lo = jst.census_transform(jnp.asarray(img))
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo)
    got = tst.census_transform(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)


def test_hamming_equals_population_count():
    a_img, b_img = _image(15, 19, seed=1), _image(15, 19, seed=2)
    ah, al = jst.census_transform(jnp.asarray(a_img))
    bh, bl = jst.census_transform(jnp.asarray(b_img))
    want = np.asarray(jst._hamming(ah, al, bh, bl))
    got = tst._hamming(tst.census_transform(torch.from_numpy(a_img)),
                       tst.census_transform(torch.from_numpy(b_img)))
    np.testing.assert_array_equal(got.numpy(), want)
    # every bit pattern of the 63-bit words, including the top bit
    words = torch.tensor([0, 1, (1 << 62), (1 << 63) - 1, 0x5555555555555555],
                         dtype=torch.int64)
    np.testing.assert_array_equal(tst._popcount63(words).numpy(),
                                  [0, 1, 1, 63, 32])


def test_disparity_cost_bit_exact():
    """Same rectified images and shifts -> the same int cost volume.

    The shift fractions lie on a 1/8 grid and the intensities are
    integers, so every blend is exact: inside its fused cost kernel XLA
    recomputes the blend at each census comparison and rounds the uses
    differently, which no other implementation reproduces (see the next
    test for arbitrary fractions).
    """
    h, w, wn = 14, 20, 28
    main = _image(h, w, seed=3)
    nbr = _image(h, wn, seed=4)
    shifts = (np.arange(24, dtype=np.float32) * 0.625 - 7.0).astype(np.float32)
    m_hi, m_lo = jst.census_transform(jnp.asarray(main))
    want = np.asarray(jst._disparity_cost(m_hi, m_lo, jnp.asarray(nbr),
                                          jnp.asarray(shifts)))
    got = tst._disparity_cost(tst.census_transform(torch.from_numpy(main)),
                              torch.from_numpy(nbr), torch.from_numpy(shifts))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_disparity_cost_matches_staged_jax_planes():
    """Arbitrary float32 fractions: each plane equals JAX's census and
    Hamming cost of the same plane blended as a fused multiply-add."""
    h, w, wn = 14, 20, 28
    main = _image(h, w, seed=3)
    nbr = _image(h, wn, seed=4)
    shifts = (np.float32(-6.3) + np.float32(0.77)
              * np.arange(12, dtype=np.float32)).astype(np.float32)
    m_hi, m_lo = jst.census_transform(jnp.asarray(main))
    P = w + wn
    pimg = np.pad(nbr, ((0, 0), (P, P)))
    got = tst._disparity_cost(tst.census_transform(torch.from_numpy(main)),
                              torch.from_numpy(nbr), torch.from_numpy(shifts))
    for d, s in enumerate(shifts):
        si = int(np.floor(s))
        a = np.float32(s - np.float32(si))
        st = int(np.clip(P - si, 1, P + wn))
        t0, t1 = pimg[:, st:st + w], pimg[:, st - 1:st - 1 + w]
        blend = ((np.float32(1) - a).astype(np.float64) * t0
                 + (a * t1).astype(np.float64)).astype(np.float32)
        warped = np.where((t0 != 0) & (t1 != 0), blend, np.float32(0))
        w_hi, w_lo = jst.census_transform(jnp.asarray(warped))
        want = np.where(warped != 0, np.asarray(
            jst._hamming(m_hi, m_lo, w_hi, w_lo)), tst.INVALID_COST)
        np.testing.assert_array_equal(got[..., d].numpy(), want)


def test_aggregate_matches_scan_version():
    cost, inten = _volume(1, 9, 13, 16, seed=5)
    want = np.asarray(jst.aggregate(jnp.asarray(cost[0], jnp.int32),
                                    jnp.asarray(inten[0]), 6, 96))
    got = cuda_agg.aggregate(torch.from_numpy(cost[0]),
                             torch.from_numpy(inten[0]), 6, 96)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1)])
def test_fused_pass_matches_pallas(reverse, shifts):
    rng = np.random.default_rng(6)
    cost = rng.integers(0, 63, size=(8, 12, 16)).astype(np.int16)
    inten = rng.integers(0, 255, size=(8, 12)).astype(np.int32)
    acc = rng.integers(0, 500, size=(8, 12, 16)).astype(np.int16)
    want = np.asarray(pallas_agg._fused_pass(
        jnp.asarray(cost), jnp.asarray(inten), jnp.asarray(acc), reverse,
        shifts, 6, 96, interpret=True))
    got = cuda_agg.fused_pass(torch.from_numpy(cost), torch.from_numpy(inten),
                              torch.from_numpy(acc), reverse, shifts, 6, 96)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [16, 24])
def test_aggregate_batch_matches_pallas_unpadded(d):
    """H and W not multiples of 8: the port drops the TPU's pad-to-8 and
    must stay bit-equal to the padded Pallas result."""
    cost, inten = _volume(2, 11, 13, d, seed=7 + d)
    want = np.asarray(pallas_agg.aggregate_batch(
        jnp.asarray(cost), jnp.asarray(inten), 6, 96, interpret=True))
    got = cuda_agg.aggregate_batch(torch.from_numpy(cost),
                                   torch.from_numpy(inten), 6, 96)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_invalid_column_pad_is_transparent():
    """`_rectified_sgm` pads the main problem with INVALID columns to the
    neighbor canvas width; the real columns' sums must not change."""
    cost, inten = _volume(1, 10, 12, 16, seed=9)
    plain = cuda_agg.plain_aggregate(torch.from_numpy(cost[0]),
                                     torch.from_numpy(inten[0]), 6, 96)
    padded = np.full((10, 20, 16), tst.INVALID_COST, np.int16)
    padded[:, :12] = cost[0]
    ipad = np.zeros((10, 20), np.int32)
    ipad[:, :12] = inten[0]
    got = cuda_agg.aggregate_batch(torch.from_numpy(padded[None]),
                                   torch.from_numpy(ipad[None]), 6, 96)
    np.testing.assert_array_equal(got[0, :, :12].numpy(), plain.numpy())


def test_wta_subpixel_matches():
    rng = np.random.default_rng(10)
    agg = rng.integers(0, 40, size=(9, 11, 16)).astype(np.int16)  # ties
    raw = rng.integers(0, 256, size=(9, 11, 16)).astype(np.int16)
    raw[raw > 240] = tst.INVALID_COST
    inten = rng.uniform(0, 255, size=(9, 11)).astype(np.float32)
    d0, ds = np.float32(-3.5), np.float32(0.25)
    want_d, want_ok = jst._wta_subpixel(jnp.asarray(agg), jnp.asarray(raw),
                                        jnp.asarray(inten), d0, ds)
    got_d, got_ok = tst._wta_subpixel(
        torch.from_numpy(agg), torch.from_numpy(raw), torch.from_numpy(inten),
        torch.tensor(d0), torch.tensor(ds))
    np.testing.assert_array_equal(
        torch.argmin(torch.from_numpy(agg), -1).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(agg), -1)))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    # float32 parabola fit: same operations, at most 1 ulp apart
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)


def test_rectify_and_warp_homography_match():
    js = jsyn.make_two_view_scene(dim=64, rotate=True, texture="noise")
    ts = tsyn.make_two_view_scene(dim=64, rotate=True, texture="noise")
    for a, b in zip(js.images, ts.images):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(js.depths[1], ts.depths[1])
    jrp = jrect.rectify_pair(js.cameras[1], js.cameras[0], 64, 64,
                             (3.5, 9.5), (3.5, 9.5))
    trp = trect.rectify_pair(ts.cameras[1], ts.cameras[0], 64, 64,
                             (3.5, 9.5), (3.5, 9.5))
    assert jrp.valid and trp.valid and jrp.nbr_pad == trp.nbr_pad
    np.testing.assert_array_equal(jrp.H_nbr, trp.H_nbr)
    assert (jrp.disp_lo, jrp.disp_hi) == (trp.disp_lo, trp.disp_hi)
    img = ts.images[0] * 255.0
    hinv = np.linalg.inv(trp.H_nbr).astype(np.float32)
    want = np.asarray(jrect.warp_homography(jnp.asarray(img),
                                            jnp.asarray(hinv), out_width=128))
    got = trect.warp_homography(torch.from_numpy(img), torch.from_numpy(hinv),
                                out_width=128).numpy()
    # float32 bilinear on a 0..255 scale: a few ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got == 0, want == 0)


def _warp_pair(name):
    """(main image, neighbor image, rectified pair) of the rotated 64 px
    two-view scene above, or of views 1 and 2 of the 5-view 160 px plane
    scene of tests/test_torch_cli_batch.py at its SGM scale (80 px)."""
    from smvs_tpu_torch.image import ops as tops

    if name == "two_view_64":
        ts = tsyn.make_two_view_scene(dim=64, rotate=True, texture="noise")
        rp = trect.rectify_pair(ts.cameras[1], ts.cameras[0], 64, 64,
                                (3.5, 9.5), (3.5, 9.5))
        return ts.images[1] * 255.0, ts.images[0] * 255.0, rp
    scene = tsyn.make_plane_scene(n_views=5, dim=160)
    main, nbr = (tops.rescale_half_size(torch.as_tensor(
        np.clip(scene.images[i] * 255.0, 0, 255).astype(np.uint8)
        .astype(np.float32))).numpy() for i in (1, 2))
    rp = trect.rectify_pair(scene.cameras[1], scene.cameras[2], 80, 80,
                            (3.4, 25.8), (3.4, 25.6))
    return main, nbr, rp


@pytest.mark.parametrize("name", ["two_view_64", "plane_160"])
def test_warp_homography_rounds_as_the_compiled_jax_warp(name):
    """Both rectified images bit-equal to the JAX package's compiled warp,
    which XLA compiles with its bilinear blends fused into multiply-adds
    (`iops.bilinear_packed4_fma`; unfused, 882-1310 pixels of these main
    images fall one ulp apart). The JAX pipeline compiles the warp inside
    `_rectified_sgm_packed`: its depth map equals `_rectified_sgm` run on
    the standalone compiled warps, so it reads the same bits there."""
    import jax

    main, nbr, rp = _warp_pair(name)
    assert rp.valid
    params = tst._pair_params(rp, 128)
    w = main.shape[1]
    warps = []
    for img, hinv, ow in ((main, params[0:9], None),
                          (nbr, params[9:18], w + 2 * rp.nbr_pad)):
        want = jrect.warp_homography(jnp.asarray(img),
                                     jnp.asarray(hinv).reshape(3, 3),
                                     out_width=ow)
        got = trect.warp_homography(torch.from_numpy(img),
                                    torch.from_numpy(hinv).reshape(3, 3),
                                    out_width=ow)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        warps.append(want)
    P = jnp.asarray(params)
    shifts = jax.jit(lambda p: p[32] + p[33] * jnp.arange(
        128, dtype=jnp.float32))(P)
    alone = jst._rectified_sgm(
        *warps, P[9:18].reshape(3, 3), P[18:27].reshape(3, 3), P[27:30],
        P[30], P[31], P[32], P[33], shifts, 6, 96, False)
    packed = jst._rectified_sgm_packed(
        jnp.asarray(main), jnp.asarray(nbr), P, 128, 6, 96, False,
        nbr_pad=rp.nbr_pad)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(alone))


def test_reconstruct_auto_matches_jax_dim96():
    dim = 96
    slope = 0.005 * 460.0 / dim
    scene = jsyn.make_two_view_scene(
        dim=dim, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    main = scene.images[1] * np.float32(255.0)
    nbr = scene.images[0] * np.float32(255.0)
    want = np.asarray(jst.reconstruct_auto(
        scene.cameras[1], scene.cameras[0], jnp.asarray(main),
        jnp.asarray(nbr), (3.5, 9.5), (3.5, 9.5)))
    got = tst.reconstruct_auto(scene.cameras[1], scene.cameras[0],
                               torch.from_numpy(main), torch.from_numpy(nbr),
                               (3.5, 9.5), (3.5, 9.5), device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (want > 0).mean() > 0.5
    # A census bit flipped by one ulp of a float32 blend may move a rare
    # pixel to another plane: masks agree on >= 99.5% of pixels, and
    # >= 99% of the pixels valid in both agree to rtol 1e-4.
    assert ((got > 0) == (want > 0)).mean() >= 0.995
    both = (got > 0) & (want > 0)
    close = np.abs(got[both] - want[both]) <= 1e-4 * np.abs(want[both])
    assert close.mean() >= 0.99


def test_reconstruct_auto_needs_a_device_or_gpu(monkeypatch):
    scene = tsyn.make_two_view_scene(dim=32, texture="noise")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.reconstruct_auto(scene.cameras[1], scene.cameras[0],
                             scene.images[1] * 255.0, scene.images[0] * 255.0,
                             (3.5, 9.5), (3.5, 9.5))


def test_unrectifiable_pair_takes_general_path():
    """Near-forward motion does not rectify (as in tests/test_sgm.py): the
    pair runs the general-warp `reconstruct` and equals JAX's fallback.

    Under x64 the JAX fallback warps in float64 (its matrices come from
    float64 numpy), the port in float32, so the depth maps are held by the
    tolerance of `test_reconstruct_auto_matches_jax_dim96`.
    """
    from smvs_tpu.core.camera import Camera as JCamera
    from smvs_tpu_torch.core.camera import Camera

    trans = np.array([0.05, 0.02, -0.4])
    cams = (Camera(flen=1.0, rot=np.eye(3), trans=trans),
            Camera(flen=1.0, rot=np.eye(3), trans=np.zeros(3)))
    jcams = (JCamera(flen=1.0, rot=np.eye(3), trans=trans),
             JCamera(flen=1.0, rot=np.eye(3), trans=np.zeros(3)))
    rng = np.random.default_rng(11)
    imgs = [np.repeat(np.repeat(rng.uniform(20, 230, (24, 24)), 2, 0), 2, 1)
            .astype(np.float32) for _ in range(2)]
    opts = tst.SGMOptions(num_steps=48)
    assert not trect.rectify_pair(cams[0], cams[1], 48, 48, (3.5, 9.5),
                                  (3.5, 9.5)).valid
    got = tst.reconstruct_auto(*cams, *imgs, (3.5, 9.5), (3.5, 9.5), opts,
                               device="cpu").numpy()
    M_mn, t_mn = cams[0].fill_reprojection(cams[1], 48, 48, 48, 48)
    M_nm, t_nm = cams[1].fill_reprojection(cams[0], 48, 48, 48, 48)
    f32 = [torch.tensor(a, dtype=torch.float32)
           for a in (M_mn, t_mn, M_nm, t_nm)]
    direct = tst.reconstruct(*[torch.from_numpy(i) for i in imgs], *f32,
                             (3.5, 9.5), (3.5, 9.5), opts).numpy()
    np.testing.assert_array_equal(got, direct)
    want = np.asarray(jst.reconstruct_auto(
        *jcams, *[jnp.asarray(i) for i in imgs], (3.5, 9.5), (3.5, 9.5),
        jst.SGMOptions(num_steps=48)))
    assert (want > 0).mean() > 0.2
    assert ((got > 0) == (want > 0)).mean() >= 0.995
    both = (got > 0) & (want > 0)
    close = np.abs(got[both] - want[both]) <= 1e-4 * np.abs(want[both])
    assert close.mean() >= 0.99
