"""The port's benchmark drivers (`smvs_tpu_torch.bench`, `bench_scene`,
`bench_dtu`) against the JAX repository's (`bench.py`, `bench_scene.py`,
`bench_dtu.py`) on the CPU at small sizes: the JAX driver's keys (and
``device``), and coverage at least 90% and median relative error at most
three times the JAX driver's on the same configuration.

The JAX scene and DTU drivers run in subprocesses (each sets
``jax_platforms`` to ``cpu`` after importing JAX), started when this
module's first test starts so that they run beside the port's drivers.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from smvs_tpu_torch import bench as tbench
from smvs_tpu_torch import bench_dtu as tdtu
from smvs_tpu_torch import bench_scene as tscene
from smvs_tpu_torch.core import synthetic as tsyn
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COV_SHARE, ERR_FACTOR = 0.9, 3.0

SCENE_ENV = dict(SMVS_SCENE_DIM="128", SMVS_SCENE_VIEWS="4",
                 SMVS_SCENE_BATCH="2", SMVS_SCENE_MIN_SCALE="2")
# Ten views, so that three take the second size: 128 and 96 pad to two
# canvases (the CLI's 32-pixel buckets), two shape buckets as at 1440/1280.
DTU_ENV = dict(SMVS_DTU_VIEWS="10", SMVS_DTU_DIM="128", SMVS_DTU_DIM2="96",
               SMVS_DTU_SCALE="0")

# The JAX driver `bench.py` at SMVS_BENCH_DIM=128, SMVS_BENCH_PASSES=1 on
# the CPU (JAX float32): coverage and median relative error of run_once
# and of run_shading_once. Taken from its JSON line rather than run here:
# its compiles take 45-90 s, and tests/test_torch_pipeline.py and
# tests/test_torch_shading_flagship.py hold the two paths against JAX
# live.
JAX_BENCH_128 = {"base": (0.8096, 0.000311),
                 "shading_flagship": (0.8789, 0.004279)}

_RUN_JAX = ("import runpy, sys\n"
            "import jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "path = sys.argv[1]\n"
            "sys.argv = [path]\n"
            "runpy.run_path(path, run_name='__main__')\n")


@pytest.fixture(scope="module")
def jax_drivers(tmp_path_factory):
    """The JAX `bench_scene.py` and `bench_dtu.py` at the sizes above, in
    two subprocesses; returns a function of the name that waits for one
    and returns its JSON line."""
    root = tmp_path_factory.mktemp("jax_drivers")
    procs = {}
    for name, script, env in (("scene", "bench_scene.py", SCENE_ENV),
                              ("dtu", "bench_dtu.py",
                               dict(DTU_ENV, SMVS_DTU_DIR=str(root / "dtu")))):
        out = open(root / f"{name}.out", "w+")
        err = open(root / f"{name}.err", "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", _RUN_JAX, os.path.join(REPO, script)],
            cwd=REPO, env={**os.environ, **env}, stdout=out, stderr=err),
            out, err)

    def result(name):
        proc, out, err = procs[name]
        rc = proc.wait(timeout=900)
        out.seek(0)
        err.seek(0)
        assert rc == 0, err.read()[-3000:]
        return json.loads(out.read().strip().splitlines()[-1])

    yield result
    for proc, out, err in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()


def _within(got, want):
    assert got["coverage"] >= COV_SHARE * want["coverage"], (got, want)
    assert got["median_rel_err"] <= ERR_FACTOR * want["median_rel_err"], \
        (got, want)


def test_measure_equals_jax(jax_drivers):
    """`_measure` of both drivers on one fake run function: the same dict
    (the JAX `_measure` is plain Python)."""
    import bench

    def fake():
        calls = iter([(1.0, 3.0, 0.81, 2e-5), (0.5, 1.5, 0.82, 3e-5),
                      (2.0, 2.0, 0.83, 1e-5)])
        return lambda dim, min_scale, verbose=True: next(calls)

    want = bench._measure("base", fake(), 1440, 2, 3)
    got = tbench._measure("base", fake(), 1440, 2, 3)
    assert got == want
    assert want["mps"] == round(1440 * 1440 / 1e6 / 4.0, 4)


def test_bench_keys_and_bars(monkeypatch, capsys):
    """`bench.run` at dim 128, one pass: the JAX driver's keys (read from
    its JSON line on fake run functions) and the bars above against the
    JAX driver's results at this size."""
    import bench

    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(bench, "run_once",
                        lambda *a, **k: (1.0, 1.0, 0.8, 1e-5))
    monkeypatch.setattr(bench, "run_shading_once",
                        lambda *a, **k: (1.0, 2.0, 0.9, 1e-3))
    monkeypatch.setenv("SMVS_BENCH_PASSES", "1")
    bench.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    got = tbench.run(dim=128, min_scale=2, passes=1, device="cpu")
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for key in ("base", "shading_flagship"):
        assert set(got[key]) == set(want[key])
        assert got[key]["passes"] == 1
        assert got[key]["mps_min"] <= got[key]["mps"] <= got[key]["mps_max"]
        cov, err = JAX_BENCH_128[key]
        _within(got[key], {"coverage": cov, "median_rel_err": err})
    assert got["value"] == got["base"]["mps"]
    assert got["vs_baseline"] == round(got["value"] / 0.025, 2)
    assert got["shading_flagship"]["vs_baseline"] == round(
        got["shading_flagship"]["mps"] / 0.01603, 2)


def test_bench_scene_matches_jax(jax_drivers):
    got = tscene.run(dim=128, n_views=4, group=2, min_scale=2, device="cpu")
    want = jax_drivers("scene")
    assert set(got) == set(want) | {"device"}
    for key in ("dim", "views", "group"):
        assert got[key] == want[key]
    assert got["coverage"] > 0.7
    _within(got, want)


def test_bench_dtu_matches_jax(jax_drivers, tmp_path):
    env = {k: int(v) for k, v in DTU_ENV.items() if k != "SMVS_DTU_SCALE"}
    got = tdtu.run(n_views=env["SMVS_DTU_VIEWS"], dim1=env["SMVS_DTU_DIM"],
                   dim2=env["SMVS_DTU_DIM2"], scene_dir=str(tmp_path / "d"),
                   device="cpu")
    want = jax_drivers("dtu")
    assert set(got) == set(want) | {"device"}
    for key in ("views", "dims", "shading", "input_scale", "mp_total"):
        assert got[key] == want[key]
    assert got["coverage"] > 0.7
    _within(got, want)


def test_bench_dtu_refuses_another_scene(tmp_path):
    """A directory holding a scene of another view count or other sizes
    raises before anything is reconstructed; a matching one is reused."""
    path = str(tmp_path / "scene")
    dims = tdtu.view_dims(8, 48, 32)
    tsyn.save_as_mve_scene(tsyn.make_dtu_scene(8, dims), path)
    assert tdtu.check_scene_dir(path, dims)
    assert not tdtu.check_scene_dir(str(tmp_path / "absent"), dims)
    for n_views, dim1, dim2 in ((10, 48, 32), (8, 48, 48), (7, 48, 32)):
        with pytest.raises(ValueError, match="another scene"):
            tdtu.run(n_views=n_views, dim1=dim1, dim2=dim2, scene_dir=path,
                     device="cpu")
    np.testing.assert_array_equal(dims, [48] * 7 + [32])
