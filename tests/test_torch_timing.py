"""The port's tracer (`smvs_tpu_torch.utils.timing`) and the reduction of
its spans in a device trace (`tools/trace_spans.py`), on the CPU.

Off, a span is one shared null context that records nothing and never
touches the profiler; on, spans nest into trees with parents and roots;
a running profiler turns them on and receives each as a host annotation.
The trace reduction attributes device operations, by the correlation id
of their launch, to every span that holds the launch, and labels idle
gaps with the innermost span; the numbers the benchmark reads today stay
as they were.
"""

import re
import time

import pytest
import torch

from benchmarks import trace as tr
from smvs_tpu_torch import cli
from smvs_tpu_torch.utils import timing
from tools import trace_spans as sp


@pytest.fixture(autouse=True)
def clean_tracer():
    timing.disable()
    timing.clear()
    yield
    timing.disable()
    timing.clear()


def _no_annotations(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_off_is_one_null_context_and_records_nothing(monkeypatch):
    _no_annotations(monkeypatch)
    a = timing.span("opt.view")
    b = timing.span("solver.pcg.iteration", scale=2)
    assert a is b
    # a stage that waits for no card is the same null context
    assert timing.stage("opt.scale", None, scale=3) is a
    assert timing.stage("opt.extract", torch.device("cpu")) is a
    with a, timing.stage("opt.scale", None, scale=3):
        with timing.span("opt.assemble"):
            pass
    assert timing.records == []


def test_spans_on_nest_into_trees_with_parents_and_roots(monkeypatch):
    _no_annotations(monkeypatch)  # no profiler runs: no annotation
    timing.enable()
    with timing.span("opt.view"):
        with timing.span("opt.scale", scale=4):
            with timing.span("opt.newton_step"):
                pass
            with timing.span("opt.cleanup"):
                pass
    with timing.span("sgm.pair"):
        pass
    names = [s.name for s in timing.records]
    assert names == ["opt.view", "opt.scale", "opt.newton_step",
                     "opt.cleanup", "sgm.pair"]
    view, scale, step, cleanup, pair = timing.records
    assert [s.index for s in timing.records] == [0, 1, 2, 3, 4]
    assert [s.parent for s in timing.records] == [-1, 0, 1, 1, -1]
    assert [s.root for s in timing.records] == [0, 0, 0, 0, 4]
    assert scale.attrs == {"scale": 4} and step.attrs == {}
    for s in timing.records:
        assert s.end_ns >= s.start_ns
    assert view.start_ns <= scale.start_ns <= step.start_ns
    assert cleanup.end_ns <= scale.end_ns <= view.end_ns
    timing.disable()
    with timing.span("opt.view"):
        pass
    assert len(timing.records) == 5


def test_a_running_profiler_turns_spans_on_as_annotations():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("solver.pcg", scale=1):
            with timing.span("solver.pcg.iteration"):
                torch.ones(8).sum()
    with timing.span("opt.view"):  # the profiler has stopped
        pass
    assert [s.name for s in timing.records] == ["solver.pcg",
                                               "solver.pcg.iteration"]
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {"solver.pcg", "solver.pcg.iteration"} <= names


@pytest.mark.parametrize("already_on", [False, True])
def test_recording_yields_its_spans_and_drops_only_its_own(already_on):
    if already_on:
        timing.enable()
    with timing.recording() as spans:
        with timing.span("cli.group"):
            pass
    assert [s.name for s in spans] == ["cli.group"]
    assert len(timing.records) == (1 if already_on else 0)
    with timing.span("opt.view"):  # tracing as it was before
        pass
    assert len(timing.records) == (2 if already_on else 0)
    with timing.recording(on=False) as spans:
        with timing.span("cli.views"):
            pass
    assert [s.name for s in spans] == (["cli.views"] if already_on else [])


def test_report_and_totals_carry_the_enclosing_scale():
    timing.enable()
    for scale in (4, 3):
        with timing.span("opt.scale", scale=scale):
            for _ in range(scale):
                with timing.span("opt.newton_step"):
                    time.sleep(0.001)
    with timing.span("opt.extract"):
        pass
    spans = list(timing.records)
    by_name = timing.totals(spans)
    assert by_name["opt.newton_step"][1] == 7
    assert by_name["opt.scale"][1] == 2
    by_scale = timing.totals(spans, by_scale=True)
    assert by_scale["opt.newton_step@s4"][1] == 4
    assert by_scale["opt.newton_step@s3"][1] == 3
    assert by_scale["opt.newton_step@s4"][0] > 0.003
    assert "opt.extract" in by_scale
    text = timing.report(spans)
    assert text.splitlines()[0] == "stage timings:"
    assert re.search(r"^  opt\.newton_step@s4 +\d+\.\d\ds  \(4 calls, +"
                     r"\d+\.\d ms avg\)$", text, re.M)


def test_stage_seconds_line_keeps_its_format():
    timing.enable()
    for _ in range(2):
        with timing.span("cli.group"):
            with timing.span("cli.views"):
                pass
            with timing.span("cli.sgm"):
                pass
            with timing.span("cli.optimize"):
                pass
    with timing.span("cli.fuse"):
        pass
    line = cli.stage_seconds(timing.records)
    assert re.fullmatch(r"Stage seconds: views \d+\.\d{3} \(2 runs\), "
                        r"sgm \d+\.\d{3} \(2 runs\), optimize \d+\.\d{3} "
                        r"\(2 runs\), fuse \d+\.\d{3} \(1 runs\)", line)


# ---------------------------------------------------------------------------
# the spans in a trace, on synthetic events
# (name, is_device, is_annotation, start, end, correlation id)

W = tr.WINDOW


def _trace(with_spans: bool = True) -> list:
    ev = [(W, False, True, 0.0, 10.0, 0)]
    if with_spans:
        ev += [("opt.view", False, True, 1.5, 8.0, 0),
               ("opt.assemble", False, True, 1.5, 3.0, 0),
               ("solver.pcg.iteration", False, True, 4.0, 5.0, 0),
               # the device-side copy of an annotation
               ("opt.view", True, True, 1.5, 8.0, 0)]
    ev += [
        # launched in opt.assemble, runs past its host end
        ("cudaLaunchKernel", False, False, 2.0, 2.1, 11),
        ("gather_kernel", True, False, 2.2, 3.5, 11),
        # launched in the PCG iteration, with its exit read
        ("cudaLaunchKernel", False, False, 4.1, 4.2, 12),
        ("spmv_kernel", True, False, 4.3, 4.6, 12),
        ("cudaMemcpyAsync", False, False, 4.7, 4.75, 13),
        ("Memcpy DtoH", True, False, 4.8, 4.85, 13),
        ("cudaStreamSynchronize", False, False, 4.75, 4.9, 0),
        # an aten op whose own id is a kernel's: never a launch
        ("aten::mul", False, False, 8.5, 8.6, 14),
        # launched outside every program span
        ("cudaLaunchKernel", False, False, 8.7, 8.8, 14),
        ("tail_kernel", True, False, 9.0, 9.5, 14),
        ("cudaDeviceSynchronize", False, False, 9.5, 9.6, 0),
        # host work that the idle gaps fall in
        ("aten::nonzero", False, False, 5.0, 7.5, 0),
        ("aten::add", False, False, 0.5, 1.4, 0),
    ]
    return ev


def test_trace_numbers_are_unchanged_by_spans():
    with_spans = tr.reduce([e[:5] for e in _trace(True)])
    without = tr.reduce([e[:5] for e in _trace(False)])
    assert with_spans.window_s == without.window_s == 10.0
    assert with_spans.busy_s == pytest.approx(without.busy_s)
    assert with_spans.kernel_s == without.kernel_s
    assert "opt.view" not in with_spans.kernel_s
    red = sp.reduce(_trace(True))
    assert red["trace"].busy_s == with_spans.busy_s
    assert red["trace"].kernel_s == with_spans.kernel_s


def test_spans_table_attributes_launches_inclusively():
    red = sp.reduce(_trace())
    t = red["spans"]
    assert set(t) == {"opt.view", "opt.assemble", "solver.pcg.iteration"}
    view, asm, it = t["opt.view"], t["opt.assemble"], t["solver.pcg.iteration"]
    assert (view["count"], asm["count"], it["count"]) == (1, 1, 1)
    assert view["launches"] == 3 and asm["launches"] == 1
    assert it["launches"] == 2
    assert asm["device_s"] == pytest.approx(1.3)
    assert it["device_s"] == pytest.approx(0.35)
    assert view["device_s"] == pytest.approx(1.65)
    assert asm["host_s"] == pytest.approx(1.5)
    assert asm["wall_s"] == pytest.approx(2.0)  # to the kernel's end, 3.5
    assert it["wall_s"] == pytest.approx(1.0)  # host end after the copy
    assert view["wall_s"] == pytest.approx(6.5)
    assert (view["syncs"], asm["syncs"], it["syncs"]) == (1, 0, 1)
    assert red["inner_syncs"] == {
        "solver.pcg.iteration | after aten::add": 1,
        "(no span) | after aten::mul": 1}
    assert red["attributed_s"] == pytest.approx(1.65)
    assert red["device_op_s"] == pytest.approx(2.15)


@pytest.mark.parametrize("label", [
    "opt.view | aten::nonzero",  # inside a span: innermost span | host op
    "after cudaDeviceSynchronize",  # outside every span: today's label
    "aten::add",
])
def test_idle_gaps_carry_the_innermost_span(label):
    labels = [g[0] for g in sp.reduce(_trace())["idle_gaps"]]
    assert label in labels
    assert not any(x.startswith("opt.view | opt.") for x in labels)


def test_traced_tiny_request_holds_the_optimizer_and_solver_spans():
    """A tiny `dtu49.seq` request under the profiler on the CPU: no device
    operations, but every span, with host and wall seconds."""
    from benchmarks import drivers
    from benchmarks.tests import tiny
    from smvs_tpu_torch.utils.timing import host_reads

    _, _, config, traffic = tiny.cell("dtu49.seq")
    drv = drivers.load(config["kind"])(config, traffic, 2**31 + 11, tiny.CPU)
    drv.render()
    drv.prepare()
    host_reads.clear()
    out, red = sp.capture(lambda: drv.run(drv.requests[0], drivers.Spans()))
    t = red["spans"]
    for name in ("cli.views", "cli.sgm",
                 "sgm.pair", "sgm.cost", "sgm.aggregate", "sgm.wta",
                 "opt.view", "opt.scale", "opt.newton_step", "opt.assemble",
                 "opt.update", "solver.pcg", "solver.pcg.iteration"):
        assert t[name]["count"] > 0 and t[name]["wall_s"] > 0, name
    # the scan's calls open the CLI's stages: one view build a view,
    # one SGM call a view holding its pairs
    assert t["cli.views"]["count"] == 1 + len(drv.neighbors[out[0]["view"]])
    assert t["cli.sgm"]["count"] == 1
    assert t["cli.sgm"]["host_s"] >= t["sgm.pair"]["host_s"]
    steps = t["opt.newton_step"]["count"]
    assert t["opt.assemble"]["count"] == steps == host_reads["newton"]
    assert t["solver.pcg.iteration"]["count"] == host_reads["cg"]
    assert t["opt.assemble"]["wall_s"] / steps > 0
    pcg = t["solver.pcg.iteration"]
    assert pcg["wall_s"] / pcg["count"] > 0
    assert len(out) == 1 and red["trace"].window_s > 0
