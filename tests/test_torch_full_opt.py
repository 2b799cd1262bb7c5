"""The optimizer's knobs against the JAX package, on the CPU: the full
optimization (`full_optimization`, the CLI's `--full-opt`: every node
active in every Newton step), the block-Jacobi preconditioner
(`precond="jacobi"`), the float32 gather (`bf16_gather=False`) and the
stall limit.

Each runs `optimize_view` from the same SGM depth with a fixed number of
Newton steps, at scales 4-3, to the optimizer bar of
tests/test_torch_pipeline.py: the same coverage mask, rtol 1.5e-3, and
fewer than 10% of pixels drifting by more than 2e-4. The exit rules of
the Newton loop are held on their own with a stubbed step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smvs_tpu.core import synthetic as jsyn
from smvs_tpu.pipeline import optimizer as jO
from smvs_tpu.pipeline import views as jviews
from smvs_tpu.sgm import stereo as jst
from smvs_tpu_torch import convert
from smvs_tpu_torch.pipeline import optimizer as tO
from torch_threads import one_torch_thread  # noqa: F401

DIM = 128


@pytest.fixture(scope="module")
def problem():
    slope = 0.005 * 460.0 / DIM
    scene = jsyn.make_two_view_scene(
        dim=DIM, rotate=True, texture="noise",
        depth_fn=lambda i, j: 5.0 + slope * i + slope * j)
    jmain, jsub = (jviews.make_view(scene.cameras[i], scene.images[i],
                                    view_id=i) for i in (1, 0))
    sgm = np.asarray(jst.reconstruct_auto(
        scene.cameras[1], scene.cameras[0], jmain.image * 255.0,
        jsub.image * 255.0, range_main=(3.5, 9.5), range_nbr=(3.5, 9.5)))
    return scene, jmain, jsub, sgm


def _both(problem, **knobs):
    scene, jmain, jsub, sgm = problem
    fields = dict(regularization=0.01, num_iterations=2, min_scale=3,
                  use_sgm=True, max_newton_steps=3, fixed_newton_steps=True,
                  **knobs)
    want = np.asarray(jO.optimize_view(jmain, [jsub], jO.OptimizerOptions(
        **fields), sgm_depth=jnp.asarray(sgm)).depth)
    tmain, tsub = (convert.view(dataclasses.asdict(scene.cameras[i]),
                                scene.images[i], view_id=i, device="cpu")
                   for i in (1, 0))
    got = tO.optimize_view(tmain, [tsub],
                           convert.options(tO.OptimizerOptions, fields),
                           sgm_depth=sgm, device="cpu").depth.numpy()
    return got, want


@pytest.mark.parametrize("knobs", [
    dict(full_optimization=True),
    dict(precond="jacobi"),
    dict(full_optimization=True, precond="jacobi"),
    dict(bf16_gather=False),
], ids=["full", "jacobi", "full-jacobi", "f32-gather"])
def test_optimize_view_knobs_match_jax(problem, knobs):
    got, want = _both(problem, **knobs)
    assert (want > 0).mean() > 0.5
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1.5e-3, atol=1e-6)
    drift = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert (drift > 2e-4).mean() < 0.10, (drift > 2e-4).mean()


def test_options_carry_the_jax_fields():
    """Every field of the JAX package's `OptimizerOptions` but `chunk`
    (its assembly's TPU chunk size) has a counterpart of the same default,
    and `convert.options` carries them across."""
    jf = {f.name: f.default for f in dataclasses.fields(jO.OptimizerOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(tO.OptimizerOptions)}
    jf.pop("chunk")
    assert tf == jf
    o = convert.options(tO.OptimizerOptions, dict(
        full_optimization=True, precond="jacobi", stall_limit=3,
        bf16_gather=False, output_name="x"))
    assert (o.full_optimization, o.precond, o.stall_limit, o.bf16_gather,
            o.output_name) == (True, "jacobi", 3, False, "x")


_Surf = dataclasses.make_dataclass("_Surf", ["nodes", "node_valid"])


def _loop(monkeypatch, opts, steps):
    """`_newton_loop` on a stubbed `_newton_step` that returns ``steps``
    (avg, n_active) pairs in turn; returns (steps taken, active passed to
    each step)."""
    seen = []
    it = iter(steps)

    def step(surf, view, vis, active, opts_, lighting):
        avg, n_act = next(it)
        seen.append(active.clone())
        new_active = torch.zeros_like(active)
        new_active.view(-1)[:n_act] = True
        return tO._StepResult(surf.nodes, new_active, False, np.float32(avg),
                              np.float32(1.0), n_act, 1)

    monkeypatch.setattr(tO, "_newton_step", step)
    surf = _Surf(torch.zeros((10, 10, 4)), torch.ones((10, 10), dtype=bool))
    _, _, n, _ = tO._newton_loop(surf, None, None, surf.node_valid, opts,
                                 None)
    return n, seen


def test_newton_loop_exits(monkeypatch):
    """Full mode keeps every node active and leaves at an average delta
    below 0.01 (the working-set mode at 0.002, or when at most 5% of the
    nodes stay active); a stall of ``stall_limit`` steps without
    improvement ends either."""
    full = tO.OptimizerOptions(full_optimization=True)
    n, seen = _loop(monkeypatch, full, [(0.5, 3), (0.05, 2), (0.005, 1)])
    assert n == 3 and all(bool(a.all()) for a in seen)
    base = tO.OptimizerOptions()
    n, seen = _loop(monkeypatch, base, [(0.5, 50), (0.005, 40),
                                        (0.001, 30)])
    assert n == 3 and int(seen[1].sum()) == 50
    n, _ = _loop(monkeypatch, base, [(0.5, 4), (0.4, 3)])
    assert n == 1  # 4 of 100 nodes active: the working set is done
    n, _ = _loop(monkeypatch, dataclasses.replace(full, stall_limit=2),
                 [(0.5, 50)] * 5)
    assert n == 3  # the first step improves, two more do not
