"""The shading-aware scan cell (`dtu49s.batch4`) on the CPU, at a tiny size.

The cell is `dtu49.batch4` under ``smvsrecon -S``. Cut as
`benchmarks/tests/tiny.py` cuts `dtu49` (160 x 120 photos, 8 views on 4
columns, requests from view 4), a batched group and a single view through
the scan driver give the plain reference's depth maps bit for bit, each
view with a fitted lighting. A traced request holds the shading spans
(``opt.lighting``, ``opt.shading``) with their attributes, and the two
per-layer metrics that read the traced request's spans find a value.
"""

import copy

import pytest
import torch

from benchmarks import drivers, run, traced
from benchmarks import trace as tr
from benchmarks.drivers import scan
from benchmarks.tests import tiny
from smvs_tpu_torch.utils import timing

CELL = "dtu49s.batch4"
SEED = 2**31 + 5


@pytest.fixture(autouse=True)
def clean_tracer():
    timing.disable()
    timing.clear()
    yield
    timing.disable()
    timing.clear()


def _driver(batch_views: int) -> scan.Driver:
    """The cell's scan driver at the tiny size, with ``batch_views`` views
    a request; rendered and prepared."""
    _, config, traffic = run.find_cell(run.load_benchmark(), CELL)
    config = copy.deepcopy(config)
    config["scene"].update(photo_size=[160, 120], views=8, cols=4)
    config["first_view"] = 4
    drv = scan.Driver(config, dict(traffic, batch_views=batch_views), SEED,
                      tiny.CPU)
    drv.render()
    drv.prepare()
    return drv


def _run_catching(drv, monkeypatch, profile: bool = False):
    """(outputs, the optimizer's results, `trace.Trace` or None) of the
    driver's first request."""
    results = []
    real = drivers.optimize

    def optimize(*a, **kw):
        out = real(*a, **kw)
        results.extend(out)
        return out

    def request():
        return drv.run(drv.requests[0], drivers.Spans())

    monkeypatch.setattr(drivers, "optimize", optimize)
    if profile:
        out, trace = tr.capture(request)
    else:
        out, trace = request(), None
    return out, results, trace


def test_dtu49s_is_dtu49_under_shading():
    bench = run.load_benchmark()
    _, s, traffic = run.find_cell(bench, CELL)
    _, base, base_traffic = run.find_cell(bench, "dtu49.batch4")
    assert traffic == base_traffic and s["kind"] == "scan"
    assert s["smvsrecon"] == dict(base["smvsrecon"], shading=True)
    assert s["reduced"] == [] and s["check"] == base["check"]
    assert s["scene"] == base["scene"]
    assert s["first_view"] == base["first_view"]
    assert set(s["assumed"]) == set(base["assumed"]) | {"shading_image",
                                                       "gamma_srgb"}
    assert "-S" in s["source"] and len(s["source"]) <= 200
    assert set(s["limits"]) == {"sgm_mismatch", "opt_gap"}


@pytest.mark.parametrize("batch_views", [4, 1])
def test_scan_under_shading_equals_the_reference(batch_views, monkeypatch):
    """A batched group, and a single view, are the plain reference's depth
    maps bit for bit, each with a lighting; spans off record nothing."""
    drv = _driver(batch_views)
    out, results, _ = _run_catching(drv, monkeypatch)
    assert timing.records == []
    group = drv.requests[0]
    assert [o["view"] for o in out] == group and len(group) == batch_views
    want = drv.reference_depths(group, [o["sgm"] for o in out])
    for o, r, w in zip(out, results, want):
        assert r.lighting is not None and r.lighting.shape == (16,)
        assert bool(torch.isfinite(r.lighting).all())
        assert torch.equal(o["depth"], w)
        assert float((o["depth"] > 0).float().mean()) > 0.3


def _scale(records, s) -> int:
    """The scale of the nearest span around ``s`` that carries one."""
    while "scale" not in s.attrs:
        s = records[s.parent]
    return s.attrs["scale"]


@pytest.fixture(scope="module")
def traced_batch():
    """The tiny cell's first request (4 views) under the profiler: its
    outputs, the optimizer's results, its span records and the metric
    context of a ``--trace 1`` run."""
    mp = pytest.MonkeyPatch()
    timing.clear()
    try:
        out, results, trace = _run_catching(_driver(4), mp, profile=True)
        records = list(timing.records)
    finally:
        mp.undo()
        timing.clear()
    return out, results, records, run.Context(trace=trace)


def test_traced_request_holds_the_shading_spans(traced_batch):
    _, results, records, _ = traced_batch
    by_name = {}
    for s in records:
        by_name.setdefault(s.name, []).append(s)
    lighting = by_name["opt.lighting"]
    # one fit of the 4 views at each scale below 4 that the request ran
    scales = {s.attrs["scale"] for s in by_name["opt.scale"]}
    assert sorted(s.attrs["scale"] for s in lighting) == sorted(
        x for x in scales if x < 4)
    assert all(s.attrs["views"] == 4 for s in lighting)
    shading = by_name["opt.shading"]
    assert all(s.attrs == {"views": 4} for s in shading)
    # the shading term of every assembly below scale 4, and of no other
    below4 = [s for s in by_name["opt.assemble"] if _scale(records, s) < 4]
    assert below4 and len(shading) == len(below4)
    assert {records[s.parent].index for s in shading} == {
        s.index for s in below4}
    assert len(by_name["opt.batch"]) == 1
    assert traced.views(records) == 4 == len(by_name["cli.sgm"])
    assert all(r.lighting is not None for r in results)


def test_readers_find_the_shading_work_and_the_passes(traced_batch,
                                                      monkeypatch):
    _, _, records, ctx = traced_batch
    monkeypatch.setattr(timing, "records", records)
    shading = run.load_reader("shading_s_per_view")(ctx)
    passes = run.load_reader("pcg_passes_per_view")(ctx)
    want = sum(s.seconds for s in records
               if s.name in ("opt.lighting", "opt.shading")) / 4
    assert shading == pytest.approx(want) and shading > 0
    n = sum(s.name == "solver.pcg.iteration" for s in records)
    assert n > 0 and passes == n / 4
    # without a trace the readers read nothing
    for name in ("shading_s_per_view", "pcg_passes_per_view"):
        assert run.load_reader(name)(run.Context()) is None


def test_base_mode_request_has_passes_and_no_shading_time():
    """A traced base-mode request (`dtu49.seq`): passes a view, and no
    shading work, so `shading_s_per_view` is left out."""
    _, _, config, traffic = tiny.cell("dtu49.seq")
    drv = drivers.load(config["kind"])(config, traffic, SEED, tiny.CPU)
    drv.render()
    drv.prepare()
    _, trace = tr.capture(lambda: drv.run(drv.requests[0],
                                          drivers.Spans()))
    ctx = run.Context(trace=trace)
    names = {s.name for s in timing.records}
    assert not names & {"opt.lighting", "opt.shading"}
    assert traced.views(timing.records) == 1
    assert run.load_reader("shading_s_per_view")(ctx) is None
    assert run.load_reader("pcg_passes_per_view")(ctx) == sum(
        s.name == "solver.pcg.iteration" for s in timing.records) > 0
