"""The port's `smvsrecon` CLI with view batching against the JAX CLI's, on
the CPU: two copies of a 5-view 160 px plane scene, both CLIs with
`--batch-views 4` (their default), so that the five views, one bucket,
run as a batched group of four and one view alone in both packages. The
bars are tests/test_torch_cli.py's.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from smvs_tpu import cli as jcli
from smvs_tpu.core import scene as jsc
from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.mesh.ply import load_ply
from smvs_tpu_torch import cli as tcli
from smvs_tpu_torch.core import synthetic as tsyn
from torch_threads import one_torch_thread  # noqa: F401

DIM = 160
N_VIEWS = 5
ARGS = ["-o", "3", "--batch-views", "4"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_batch")
    jpath, tpath = str(root / "jax"), str(root / "port")
    jsyn.save_as_mve_scene(jsyn.make_plane_scene(n_views=N_VIEWS, dim=DIM),
                           jpath)
    scene = tsyn.make_plane_scene(n_views=N_VIEWS, dim=DIM)
    tsyn.save_as_mve_scene(scene, tpath)
    jrc, jout = _run(jcli.main, [jpath, "--platform", "cpu", *ARGS])
    trc, tout = _run(tcli.main, [tpath, "--device", "cpu", *ARGS])
    return dict(jpath=jpath, tpath=tpath, jrc=jrc, trc=trc, jout=jout,
                tout=tout, scene=scene)


def _groups(out):
    return re.findall(r"Views \[([\d, ]+)\] done in [\d.]+s "
                      r"\((\d+) neighbors, (batched|sequential)\)", out)


def test_cli_batches_views_as_the_jax_cli(runs):
    assert runs["jrc"] == 0 and runs["trc"] == 0
    groups = _groups(runs["tout"])
    assert groups == _groups(runs["jout"])
    assert any(kind == "batched" for _, _, kind in groups)
    assert sorted(int(i) for g, _, _ in groups for i in g.split(",")) == \
        list(range(N_VIEWS))
    assert "Stage seconds: " in runs["tout"]
    help_text = " ".join(tcli.build_parser().format_help().split())
    assert "up to N views of one shape together" in help_text


def _embeddings(path, name):
    return [np.asarray(v.get_image(name))
            for v in jsc.Scene.load(path).views]


# Views 1 and 3 pair with the center view 2, whose rectified cost volume
# the JAX program rounds differently from the JAX package's own census of
# the same planes (XLA fuses the plane blend into the census comparisons;
# `test_center_pair_cost_is_the_jax_census_of_the_same_planes`), which
# moves 3-5% of their averaged depths by up to 3e-3 (0.968 and 0.952 of
# them within 1e-4; the other views >= 0.995). ROADMAP.md queue 3 records
# it. Their bar sits just under those readings; every other view is held
# to tests/test_torch_cli.py's 99%.
SGM_CLOSE_BAR = {1: 0.94, 3: 0.94}


def test_cli_batch_sgm_embeddings_match_jax(runs):
    """tests/test_torch_cli.py's SGM bar, view by view (the two views of
    `SGM_CLOSE_BAR` excepted)."""
    pairs = zip(_embeddings(runs["jpath"], "smvs-sgm"),
                _embeddings(runs["tpath"], "smvs-sgm"))
    for view, (want, got) in enumerate(pairs):
        assert got.shape == want.shape == (DIM // 2, DIM // 2)
        assert (want > 0).mean() > 0.7
        assert ((got > 0) == (want > 0)).mean() >= 0.995
        both = (got > 0) & (want > 0)
        rel = np.abs(got[both] - want[both]) / np.abs(want[both])
        close = (rel <= 1e-4).mean()
        bar = SGM_CLOSE_BAR.get(view, 0.99)
        assert close >= bar, f"view {view}: {close:.4f} within 1e-4 < {bar}"
        assert rel.max() <= 1e-2


def test_center_pair_cost_is_the_jax_census_of_the_same_planes():
    """The rectified SGM of view 1 against the center view 2 of this
    scene at the SGM scale: on the JAX package's compiled rectifying
    warps, the port's cost volume equals the JAX package's census and
    Hamming cost of the same blended planes, compiled plane by plane. So
    what keeps the CLIs' SGM depths of views 1 and 3 apart is how XLA
    rounds (the warps' blends fused into FMAs, the plane blend inside its
    census fusion), not the port's census."""
    import jax
    import jax.numpy as jnp
    import torch

    from smvs_tpu.sgm import rectify as jR
    from smvs_tpu.sgm import stereo as jst
    from smvs_tpu_torch.image import ops as tops
    from smvs_tpu_torch.sgm import rectify as tR
    from smvs_tpu_torch.sgm import stereo as tst

    scene = tsyn.make_plane_scene(n_views=N_VIEWS, dim=DIM)
    imgs = [torch.as_tensor(np.clip(im * 255.0, 0, 255).astype(np.uint8)
                            .astype(np.float32)) for im in scene.images]
    half = [tops.rescale_half_size(im) for im in imgs]
    w = DIM // 2
    rp = tR.rectify_pair(scene.cameras[1], scene.cameras[2], w, w,
                         (3.4, 25.8), (3.4, 25.6))
    assert rp.valid
    params = tst._pair_params(rp, 128)
    P = torch.as_tensor(params)
    warp_j = jax.jit(jR.warp_homography, static_argnames=("out_width",))
    main_r = torch.as_tensor(np.asarray(warp_j(
        jnp.asarray(half[1].numpy()), jnp.asarray(params[0:9]).reshape(3, 3))))
    nbr_r = torch.as_tensor(np.asarray(warp_j(
        jnp.asarray(half[2].numpy()), jnp.asarray(params[9:18]).reshape(3, 3),
        out_width=w + 2 * rp.nbr_pad)))

    shifts = tst._fma(P[33], torch.arange(128, dtype=torch.float32), P[32])
    cost = tst._disparity_cost(tst.census_transform(main_r), nbr_r, shifts)

    @jax.jit
    def plane_cost(warped, m_hi, m_lo):
        w_hi, w_lo = jst.census_transform(warped)
        c = jst._hamming(m_hi, m_lo, w_hi, w_lo)
        return jnp.where(warped != 0, c, jst.INVALID_COST)

    m_hi, m_lo = jax.jit(jst.census_transform)(jnp.asarray(main_r.numpy()))
    wn = nbr_r.shape[1]
    pad = w + wn
    pimg = torch.nn.functional.pad(nbr_r, (pad, pad))
    si = torch.floor(shifts).to(torch.int32)
    frac = shifts - si.to(torch.float32)
    for d, s in enumerate(torch.clamp(pad - si, 1, pad + wn).tolist()):
        t0, t1 = pimg[:, s:s + w], pimg[:, s - 1:s - 1 + w]
        warped = torch.where((t0 != 0) & (t1 != 0),
                             tst._fma(1 - frac[d], t0, frac[d] * t1), 0.0)
        np.testing.assert_array_equal(
            cost[..., d].numpy(),
            np.asarray(plane_cost(jnp.asarray(warped.numpy()), m_hi, m_lo)))


def test_cli_batch_depth_embeddings_match_jax(runs):
    """tests/test_torch_cli.py's optimizer bound: the same mask, rtol
    1.5e-3, fewer than 10% of pixels drifting by > 2e-4."""
    pairs = list(zip(_embeddings(runs["jpath"], "smvs-B0"),
                     _embeddings(runs["tpath"], "smvs-B0")))
    assert len(pairs) == N_VIEWS
    for want, got in pairs:
        assert got.shape == want.shape == (DIM, DIM)
        np.testing.assert_array_equal(got > 0, want > 0)
        m = want > 0
        assert m.mean() > 0.6
        np.testing.assert_allclose(got[m], want[m], rtol=1.5e-3)
        rel = np.abs(got[m] - want[m]) / np.abs(want[m])
        assert (rel > 2e-4).mean() < 0.1


def test_cli_batch_point_clouds_match_jax(runs):
    want = load_ply(os.path.join(runs["jpath"], "smvs-B0.ply"))
    got = load_ply(os.path.join(runs["tpath"], "smvs-B0.ply"))
    assert len(want.vertices) > 1000
    assert abs(len(got.vertices) - len(want.vertices)) <= \
        0.01 * len(want.vertices)
    scene = runs["scene"]
    cam = scene.cameras[1]
    p_cam = got.vertices @ cam.rot.T + cam.trans
    uv = cam.project(p_cam, DIM, DIM)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < DIM) & (uv[:, 1] >= 0) & \
        (uv[:, 1] < DIM) & (p_cam[:, 2] > 0)
    gt = scene.depths[1][uv[inb, 1].astype(int), uv[inb, 0].astype(int)]
    rel = np.abs(p_cam[inb, 2] - gt) / gt
    assert np.median(rel) < 0.01
