"""The port's tracer: spans over the program's stages, and a count of the
host's read-backs.

`span(name, **attrs)` marks a stage (``with span("opt.scale", scale=3):``).
Tracing is off by default, and a span is then one shared null context: no
allocation, no clock, no profiler call. It is on between `enable()` and
`disable()`, inside `recording()`, and while a `torch.profiler` runs. Each
span then appends a `Span` record to `records` (name, attrs,
`perf_counter_ns` start and end, the indices of its enclosing span and of
its tree's root span) and, under a running profiler, enters
`torch.profiler.record_function(name)`, so the trace holds the span as a
host annotation on the kernels' clock. A span never synchronizes the
device: its host times cover what the host did, and the device work it
launched is attributed in a profiler trace by the launch calls it holds.

`stage` is a span that can wait for the device at its end (the
optimizer's stages under ``-d 2``); `totals` and `report` sum span
records by name (``-d 1``'s stage report, the command line's
``Stage seconds:`` line).

`host_reads` counts the main path's explicit read-backs to the host, one
per read, by site: "cg" (a PCG iteration's exit flags), "newton" (a
Newton step's scalars), "assemble" (the assembly's active-patch
compaction and per-view counts), "active" (a Newton loop's initial
working-set sizes), "patches" (a scale's patch counts), "cut" (the
boundary cut's compaction and deleted count), "shifts" (a rectified
cost volume's plane offsets) and "lighting" (on a card, the SVD of a
view's lighting fit, which checks its convergence on the host); one read
serves every view of a batch, but "lighting" counts one a view.
`host_reads.clear()` resets it. `pcg_passes` counts the PCG loop's passes
by how they ran, "eager" (launched op by op) or "replayed" (from the
solve's CUDA graph), and the graphs captured ("captures", one a solve
that replays); `pcg_passes.clear()` resets it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter

import torch
import torch.autograd.profiler as _profiler

host_reads: Counter = Counter()
pcg_passes: Counter = Counter()
records: list = []  # every `Span` made while tracing was on, in start order

_on = False
_NULL = contextlib.nullcontext()
_local = threading.local()  # each thread's stack of open span indices


class Span:
    """One span's record: ``name``, ``attrs``, ``start_ns`` and ``end_ns``
    (`time.perf_counter_ns`; ``end_ns`` None while open), its ``index`` in
    `records`, ``parent`` (the enclosing span's index, -1 for none) and
    ``root`` (the index of its tree's root span)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "index", "parent",
                 "root", "_annotation")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.end_ns = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.index = len(records)
        self.parent = stack[-1] if stack else -1
        self.root = records[self.parent].root if stack else self.index
        stack.append(self.index)
        records.append(self)
        self._annotation = None
        if _profiler._is_profiler_enabled:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _local.stack.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, **attrs):
    """A context manager that records the block as the span ``name`` while
    tracing is on; one shared null context while it is off."""
    if _on or _profiler._is_profiler_enabled:
        return Span(name, attrs)
    return _NULL


def stage(name: str, sync: torch.device | None = None, **attrs):
    """`span` that, given a CUDA device as ``sync``, waits for the device
    before the span ends, so the span's host time covers its device work
    (at the cost of the overlap); without one, `span` itself."""
    if sync is None or sync.type != "cuda":
        return span(name, **attrs)
    return _synced(span(name, **attrs), sync)


@contextlib.contextmanager
def _synced(block, device: torch.device):
    with block:
        yield
        torch.cuda.synchronize(device)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def clear() -> None:
    """Drops every span record."""
    records.clear()


@contextlib.contextmanager
def recording(on: bool = True):
    """Tracing on for the block (with ``on``); yields a list that receives
    the block's span records when the block ends. Records that only this
    block wanted (tracing was off before it and no profiler runs) are then
    dropped from `records`."""
    global _on
    was, first, out = _on, len(records), []
    _on = was or on
    try:
        yield out
    finally:
        _on = was
        out.extend(records[first:])
        if on and not was and not _profiler._is_profiler_enabled:
            del records[first:]


def _labels(spans) -> list:
    """Each span's name, with ``@s<scale>`` from its own ``scale`` attr or
    its nearest enclosing span's."""
    scale_at, out = {}, []
    for s in spans:
        scale = s.attrs.get("scale", scale_at.get(s.parent))
        scale_at[s.index] = scale
        out.append(s.name if scale is None else f"{s.name}@s{scale}")
    return out


def totals(spans, by_scale: bool = False) -> dict:
    """{name: [seconds, count]} over closed spans; with ``by_scale`` the
    names carry the scale (``opt.newton_step@s2``)."""
    out = {}
    names = _labels(spans) if by_scale else (s.name for s in spans)
    for s, name in zip(spans, names):
        if s.end_ns is None:
            continue
        t = out.setdefault(name, [0.0, 0])
        t[0] += s.seconds
        t[1] += 1
    return out


def report(spans) -> str:
    """The stage report: seconds, calls and the mean by span name and
    scale, the largest total first."""
    lines = ["stage timings:"]
    for name, (t, c) in sorted(totals(spans, by_scale=True).items(),
                               key=lambda kv: -kv[1][0]):
        lines.append(f"  {name:<28s} {t:8.2f}s  ({c} calls, "
                     f"{t / max(c, 1) * 1000:7.1f} ms avg)")
    return "\n".join(lines)
