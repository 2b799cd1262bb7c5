"""The comparison fails its control and every fault the cells can have.

The control is the plain reference in the program's place, one precision
below the configuration's (`control.readings`). The faults are planted in
the port underneath a whole run (the look for a card skipped, the rest of
the run driven as on the card): a step that returns its state unchanged
(the optimizer hands back its SGM initialization), half of a batch left out
(its results copied from the other half), an answer altered where it
is produced (the final depth map; the SGM depth map), an answer altered
only after the warm-up, and a stale answer (another pair's maps served
again). One card has no exchange between cards to leave out.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import numpy as np

from benchmarks import check, control, drivers
from benchmarks.drivers import pair, scan
from benchmarks.tests import tiny
from smvs_tpu_torch.pipeline import optimizer as O


@pytest.mark.parametrize("name", ["rect2mp.seq", "dtu49.batch4"])
def test_control_fails_and_the_program_passes(name):
    _, c, config, traffic = tiny.cell(name)
    r = control.readings(c, config, traffic, 2**33 + 5, 0.0, tiny.CPU)
    ok, _ = check.verdict(r["program"], config["limits"])
    assert ok, r["program"]
    ok, _ = check.verdict(r["control"], config["limits"])
    assert not ok, r["control"]
    assert r["control"]["sgm_mismatch"] > 100 * config["limits"][
        "sgm_mismatch"]


@pytest.mark.parametrize("name", ["rect2mp.seq", "dtu49.seq",
                                  "dtu49.batch4"])
def test_sound_run_is_correct(name):
    assert tiny.run_tiny(name)["correct"]


def _unchanged(main, subs, opts, sgm_depth=None, **kw):
    """The optimizer returning its initial state: the SGM depth map."""
    d = torch.as_tensor(sgm_depth, dtype=torch.float32)
    return O.DepthResult(depth=d, normals=torch.zeros((*d.shape, 3)),
                         surface=None)


def test_state_returned_unchanged_fails(monkeypatch):
    monkeypatch.setattr(drivers.O, "optimize_view", _unchanged)
    assert not tiny.run_tiny("rect2mp.seq")["correct"]
    assert not tiny.run_tiny("dtu49.seq")["correct"]


def test_batch_state_returned_unchanged_fails(monkeypatch):
    def batch(mains, subs_list, opts, sgm_depths=None, **kw):
        return [_unchanged(m, s, opts, d)
                for m, s, d in zip(mains, subs_list, sgm_depths)]

    monkeypatch.setattr(drivers.VB, "optimize_view_batch", batch)
    assert not tiny.run_tiny("dtu49.batch4")["correct"]


def test_half_of_the_batch_left_out_fails(monkeypatch):
    real = drivers.VB.optimize_view_batch

    def half(mains, subs_list, opts, sgm_depths=None, **kw):
        n = max(1, len(mains) // 2)
        got = real(mains[:n], subs_list[:n], opts, sgm_depths=sgm_depths[:n],
                   **kw) if n > 1 else [O.optimize_view(
                       mains[0], subs_list[0], opts, sgm_depths[0],
                       device=kw.get("device"))]
        return [got[i % n] for i in range(len(mains))]

    monkeypatch.setattr(drivers.VB, "optimize_view_batch", half)
    res = tiny.run_tiny("dtu49.batch4")
    assert not res["correct"]
    assert res["checks"]["opt_gap"]["value"] > \
        res["checks"]["opt_gap"]["limit"]


def test_final_depth_altered_fails(monkeypatch):
    real = drivers.O.optimize_view

    def altered(*a, **kw):
        r = real(*a, **kw)
        return dataclasses.replace(r, depth=r.depth * 1.01)

    monkeypatch.setattr(drivers.O, "optimize_view", altered)
    res = tiny.run_tiny("rect2mp.seq")
    assert not res["correct"]
    assert res["checks"]["sgm_mismatch"]["value"] == 0.0
    assert res["checks"]["opt_gap"]["value"] > \
        res["checks"]["opt_gap"]["limit"]


def _alter(d):
    d = d.clone() if isinstance(d, torch.Tensor) else d.copy()
    h, w = d.shape
    d[h // 4: h // 2, w // 4: w // 2] *= 1.05
    return d


def test_sgm_depth_altered_fails(monkeypatch):
    real_pair = pair.sgm.reconstruct_auto
    real_scan = scan.cli.reconstruct_sgm

    monkeypatch.setattr(pair.sgm, "reconstruct_auto",
                        lambda *a, **kw: _alter(real_pair(*a, **kw)))
    monkeypatch.setattr(scan.cli, "reconstruct_sgm",
                        lambda *a, **kw: _alter(real_scan(*a, **kw)))
    for name in ("rect2mp.seq", "dtu49.seq"):
        res = tiny.run_tiny(name)
        assert not res["correct"]
        assert res["checks"]["sgm_mismatch"]["value"] > \
            res["checks"]["sgm_mismatch"]["limit"]


def test_answer_altered_after_the_warm_up_fails(monkeypatch):
    """The warm-up's answer is right and the window's is not: the check
    reads the window's."""
    real = pair.sgm.reconstruct_auto
    calls = []

    def later(*a, **kw):
        calls.append(1)
        d = real(*a, **kw)
        return _alter(d) if len(calls) > 1 else d

    monkeypatch.setattr(pair.sgm, "reconstruct_auto", later)
    res = tiny.run_tiny("rect2mp.seq")
    assert len(calls) == 2 and not res["correct"]
    assert res["checks"]["sgm_mismatch"]["value"] > \
        res["checks"]["sgm_mismatch"]["limit"]


@pytest.mark.parametrize("stage", ["sgm", "opt"])
def test_stale_answer_of_another_pair_fails(monkeypatch, stage):
    """Every request served the first request's maps: the pairs' textures
    differ, so the reference of each pair tells them apart."""
    _, _, config, traffic = tiny.cell("rect2mp.seq")
    first = {}
    if stage == "sgm":
        real = pair.sgm.reconstruct_auto
        monkeypatch.setattr(pair.sgm, "reconstruct_auto", lambda *a, **kw:
                            first.setdefault("d", real(*a, **kw)))
    else:
        real = drivers.O.optimize_view
        monkeypatch.setattr(drivers.O, "optimize_view", lambda *a, **kw:
                            first.setdefault("r", real(*a, **kw)))
    config["check"]["views"] = 3
    drv = pair.Driver(config, traffic, 2**32 + 1, tiny.CPU)
    drv.render()
    drv.prepare()
    outputs = []
    for group in drv.requests:
        outputs += drv.run(group, drivers.Spans())
    numbers = drv.check(outputs, np.random.default_rng(3))
    ok, checks = check.verdict(numbers, config["limits"])
    assert not ok
    name = "sgm_mismatch" if stage == "sgm" else "opt_gap"
    assert checks[name]["value"] > checks[name]["limit"], checks
