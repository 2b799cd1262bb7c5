"""The port's multi-process paths on the CPU over gloo: the 4-process
`python -m smvs_tpu_torch.dist.multihost` run over ``tcp://``, the view
batch over a ('views', 1) mesh (`optimize_view_batch(mesh=...)`) against
the unsharded batch and the JAX package's sharded one, the dry run of
the full pipeline (`dist.dryrun`), and the scaling harness
(`dist.scaling`).
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as ranks
from smvs_tpu.pipeline import batch as jB
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.core import synthetic as jsyn
from smvs_tpu_torch.dist import dryrun, launch, scaling
from smvs_tpu_torch.dist.testing import plane_view_problem
from smvs_tpu_torch.pipeline import batch as tB
from smvs_tpu_torch.pipeline import optimizer as tO
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_multihost_four_processes():
    """Four workers over tcp:// on a (2, 2) mesh (views across processes,
    node rows split within each pair), each holding its shard to a
    single-process step at the JAX worker's float32 bar."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "smvs_tpu_torch.dist.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "4",
         "--process-id", str(i), "--backend", "gloo", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(4)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert (f"MULTIHOST_OK process={i} shards=1 "
                "mesh={'views': 2, 'patch': 2}") in out, out


def test_optimize_view_batch_on_mesh(tmp_path):
    """Over a (2, 1) mesh each rank gets both views' results, bit-equal to
    the unsharded batch; the JAX package's batch over make_view_mesh(4, 1)
    is within tests/test_batch.py's sharded bar of them."""
    opts = tO.OptimizerOptions(**ranks.BATCH_OPTS)
    mains, subs, inits = plane_view_problem(2, device="cpu")
    want = tB.optimize_view_batch(mains, subs, opts, init_depths=inits,
                                  device="cpu")
    outs = launch.spawn(ranks.batch_on_mesh, 2, backend="gloo",
                        device="cpu", store_path=str(tmp_path / "store"),
                        args=(1,), timeout=300)
    assert [list(o["share"]) for o in outs] == [[0], [1]]
    for o in outs:
        for got, w in zip(o["results"], want):
            s = w.surface
            for a, b in zip(got[:5], (w.depth, w.normals, s.nodes,
                                      s.node_valid, s.patch_valid)):
                assert ranks.same_bits(a, b)
            assert got[5] == (s.scale, s.start_x, s.start_y, s.width,
                              s.height)
            assert got[6] is None and w.lighting is None

    scene = jsyn.make_plane_scene(n_views=3, dim=96)
    jv = [jviews.make_view(scene.cameras[i], scene.images[i], view_id=i)
          for i in range(3)]
    jres = jB.optimize_view_batch(
        [jv[0], jv[2]], [[jv[1]], [jv[1]]],
        jO.OptimizerOptions(**ranks.BATCH_OPTS),
        init_depths=[jnp.asarray(d) for d in inits],
        mesh=jB.make_view_mesh(4, patch_axis=1))
    for jr, w in zip(jres, want):
        d_jax = np.asarray(jr.depth)
        d_out = w.depth.numpy()
        np.testing.assert_allclose(d_out, d_jax, rtol=1e-3, atol=1e-3)
        drift = np.abs(d_out - d_jax) / np.maximum(np.abs(d_jax), 1e-6)
        assert (drift > 2e-4).mean() < 0.10, (drift > 2e-4).mean()


def test_dryrun_two_ranks(capsys):
    dryrun.dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip ok: mesh={'views': 1, 'patch': 2} views=1" \
        in capsys.readouterr().out


@pytest.mark.parametrize("n", [1, 2])
def test_scaling_measure(n):
    thr = scaling.measure(n, 1, steps=1, backend="gloo", device="cpu")
    assert np.isfinite(thr) and thr > 0
