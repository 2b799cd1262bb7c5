"""The metric arithmetic on fixed inputs."""

from __future__ import annotations

import math

import pytest
import torch

from benchmarks import check, run, trace


def ctx(**kw):
    base = dict(views=10, seconds=20.0, mp=20.736, setup_s=17.5,
                peak_bytes=3 * 2**30, spans={"sgm": 9.0, "opt": 10.5},
                counters={"sgm_launches": 40, "host_reads": 420})
    base.update(kw)
    return run.Context(**base)


def read(name, c):
    return run.load_reader(name)(c)


def test_window_rate_and_per_view_metrics():
    c = ctx()
    assert read("depth_mps", c) == pytest.approx(20.736 / 20.0)
    assert read("peak_mem_gib", c) == 3.0
    assert read("setup_s", c) == 17.5
    assert read("sgm_s_per_view", c) == 0.9
    assert read("opt_s_per_view", c) == 1.05
    assert read("sgm_launches_per_view", c) == 4.0
    assert read("host_reads_per_view", c) == 42.0


def test_readers_read_nothing_without_their_source():
    c = ctx(views=0)
    for name in ("depth_mps", "sgm_s_per_view", "opt_s_per_view",
                 "sgm_launches_per_view", "host_reads_per_view"):
        assert read(name, c) is None
    for name in ("device_idle_share", "sgm_kernel_roofline"):
        assert read(name, ctx()) is None


def test_union_of_busy_intervals_and_gaps():
    spans = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (6.0, 12.0)]
    assert trace.busy_seconds(spans, 0.0, 10.0) == 8.0
    assert trace.busy_seconds(spans, 2.5, 6.5) == 2.0
    assert trace.idle_gaps(spans, 0.0, 10.0) == [(3.0, 5.0)]
    assert trace.idle_gaps([(1.0, 2.0)], 0.0, 4.0) == [(0.0, 1.0), (2.0, 4.0)]


def test_trace_reduction_idle_share_and_gap_labels():
    events = [
        (trace.WINDOW, False, True, 0.0, 10.0),
        (trace.WINDOW, True, False, 0.0, 10.0),  # its device-side copy
        ("aten::item", False, False, 4.0, 6.5),
        ("sgm_line_kernel", True, False, 1.0, 4.0),
        ("Memcpy DtoH", True, False, 6.0, 7.0),
    ]
    t = trace.reduce(events)
    assert t.window_s == 10.0 and t.busy_s == 4.0
    assert t.kernel_s == {"sgm_line_kernel": 3.0, "Memcpy DtoH": 1.0}
    assert t.longest_gaps[0] == ["after Memcpy DtoH", 3.0] or \
        t.longest_gaps[0][1] == 3.0
    assert ["aten::item", 2.0] in t.longest_gaps
    c = ctx(trace=t, traced_sgm_pairs=[(10, 20, 8)])
    assert read("device_idle_share", c) == pytest.approx(60.0)


ROOFLINE = run.load_reader("sgm_kernel_roofline").__globals__


@pytest.mark.parametrize("shape,bytes_", [
    ((1440, 1440, 128), 2 * (1440 * 1440 * 128 * 4 + 1440 * 1440 * 4)),
    ((300, 400, 128), 2 * (300 * 400 * 128 * 4 + 300 * 400 * 4)),
])
def test_roofline_bytes_of_each_cells_shapes(shape, bytes_):
    assert ROOFLINE["pair_bytes"](*shape) == bytes_


def test_roofline_share():
    t = trace.Trace(window_s=1.0, busy_s=0.5, longest_gaps=[],
                    kernel_s={"void sgm_sweep3_kernel<4, false>(...)": 0.004,
                              "sgm_line_kernel": 0.006, "elementwise": 9.0})
    c = ctx(trace=t, traced_sgm_pairs=[(1440, 1440, 128)])
    want = 100 * ROOFLINE["pair_bytes"](1440, 1440, 128) / 3.35e12 / 0.010
    assert read("sgm_kernel_roofline", c) == pytest.approx(want)
    assert 0 < want < 100


def test_depth_err_counts_missing_depth_as_error_one():
    truth = torch.full((10, 10), 5.0, dtype=torch.float64)
    depth = truth * (1 + 1e-4)
    assert check.depth_err(depth, truth, 0.5) == pytest.approx(1e-4)
    depth[:6] = 0.0  # 60% without depth
    assert check.depth_err(depth, truth, 0.5) == 1.0
    assert check.depth_err(depth, truth, 0.3) == pytest.approx(1e-4)
    assert check.depth_err(depth[:5], truth, 0.5) == 1.0


def test_sgm_mismatch_share():
    ref = torch.full((4, 5), 6.0)
    prog = ref.clone()
    assert check.sgm_mismatch(prog, ref, 1e-5) == 0.0
    prog[0, 0] = 0.0
    prog[1, 1] *= 1.001
    prog[2, 2] *= 1 + 1e-7
    assert check.sgm_mismatch(prog, ref, 1e-5) == pytest.approx(2 / 20)
    assert check.sgm_mismatch(prog[:2], ref, 1e-5) == 1.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0],
                     dtype=torch.float32)
    got = check.tf32(x)
    assert got[0] == 1.0 and got[3] == -3.0
    assert got[1] == 1.0 + 2**-10  # ties round away from zero
    assert got[2] == 1.0 + 2**-10
    assert math.isclose(float(check.tf32(torch.tensor([0.1]))), 0.1,
                        rel_tol=2**-11)


def test_verdict():
    ok, checks = check.verdict({"sgm_mismatch": 0.0, "depth_err": 1e-5},
                               {"sgm_mismatch": 1e-3, "depth_err": 1e-4})
    assert ok and checks["depth_err"] == {"value": 1e-5, "limit": 1e-4}
    ok, _ = check.verdict({"sgm_mismatch": 0.0, "depth_err": 2e-4},
                          {"sgm_mismatch": 1e-3, "depth_err": 1e-4})
    assert not ok
    ok, _ = check.verdict({"sgm_mismatch": None, "depth_err": 0.0},
                          {"sgm_mismatch": 1e-3, "depth_err": 1e-4})
    assert not ok
