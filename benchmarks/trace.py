"""Device trace of one request under `torch.profiler`, reduced to numbers.

`capture` runs a callable under the profiler (host and device activity)
inside a span named ``bench.traced`` and returns a `Trace`: the traced
window, the device's busy seconds (the union of kernel and copy intervals
inside the window, `busy_seconds`), device time by kernel name, and the
longest idle gaps labelled by what the host was doing. Nothing is written
to disk.
"""

from __future__ import annotations

import bisect
import dataclasses

import torch

WINDOW = "bench.traced"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict  # device seconds by kernel or copy name
    longest_gaps: list  # [host activity, seconds] of the longest idle gaps


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi);
    the intervals in any order."""
    busy, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            busy += end - start
            reach = end
    return busy


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The [start, end) gaps in [lo, hi) that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach and reach < hi:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
    if reach < hi:
        gaps.append((reach, hi))
    return gaps


def _events(prof):
    """(name, is_device, is_annotation, start_s, end_s) of every event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e9
        out.append((e.name(), e.device_type() == DeviceType.CUDA,
                    bool(e.is_user_annotation()), start,
                    start + e.duration_ns() / 1e9))
    return out


def reduce(events) -> Trace:
    """A `Trace` from (name, is_device, is_annotation, start, end) events."""
    annotations = {n for n, dev, ann, _, _ in events if ann and not dev}
    annotations |= {WINDOW, "Command Buffer Full"}
    windows = [(s, e) for n, dev, _, s, e in events
               if n == WINDOW and not dev]
    if not windows:
        raise RuntimeError("the trace holds no traced window")
    lo, hi = windows[0]
    device = [(n, s, e) for n, dev, _, s, e in events
              if dev and n not in annotations]
    kernel_s = {}
    for n, s, e in device:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s)
    spans = [(s, e) for _, s, e in device]
    host = sorted((s, e, n) for n, dev, _, s, e in events
                  if not dev and n != WINDOW)
    starts = [s for s, _, _ in host]
    gaps = sorted(idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])
    longest = [[_host_label(host, starts, 0.5 * (g0 + g1)), g1 - g0]
               for g0, g1 in gaps[:10]]
    return Trace(window_s=hi - lo, busy_s=busy_seconds(spans, lo, hi),
                 kernel_s=kernel_s, longest_gaps=longest)


def _host_label(host, starts, t: float, reach: int = 200000) -> str:
    """What the host was doing at time t: the innermost host event holding
    t, else "after" the last one that ended before t."""
    j = bisect.bisect_right(starts, t)
    inner, last = None, None
    for s, e, n in reversed(host[max(0, j - reach):j]):
        if e > t:
            if inner is None or e - s < inner[1] - inner[0]:
                inner = (s, e, n)
        elif last is None or e > last[1]:
            last = (s, e, n)
    if inner is not None:
        return inner[2]
    return "after " + last[2] if last is not None else "python"


def capture(fn):
    """(fn's result, `Trace` of the call)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            result = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return result, reduce(_events(prof))


def top(table: dict, n: int = 10) -> list:
    """The ``n`` largest entries as [name, seconds], largest first."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]
