"""The program's spans in a device trace: the kernels, launches and syncs
that each span of `smvs_tpu_torch.utils.timing` holds (for
`tools/span_trace.py`; the spans reduction that `benchmarks/trace.py`
lacks until it gains correlation ids and a spans table).

A running `torch.profiler` turns the program's spans on, and each span is
then a host annotation in the trace, on the kernels' clock. `capture` runs
a callable under the profiler as `trace.capture` does and reduces the
trace with `reduce`:

- ``trace``: `trace.reduce` of the same events, the numbers the benchmark
  reads today (window, busy and kernel seconds, longest idle gaps);
- ``spans``: for each program span name, summed over its spans in the
  window: ``count``, ``host_s`` (host start to host end), ``wall_s`` (host
  start to the later of host end and the end of the last device operation
  launched inside), ``device_s`` (the device seconds of the operations
  launched inside), ``launches`` and ``syncs``. A device operation (a
  kernel, copy or fill) is launched inside a span when the host's launch
  call with its correlation id starts inside it; a sync is a host
  ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize`` or blocking ``cudaMemcpy`` call. Each figure is
  inclusive: ``opt.view`` counts its ``solver.pcg`` work;
- ``attributed_s`` and ``device_op_s``: the device seconds of operations
  launched inside some program span, and of all operations;
- ``inner_syncs``: the syncs by innermost program span and the innermost
  host operation that holds the sync call (``"opt.update | aten::copy_"``),
  which names where each sits;
- ``idle_gaps``: the longest idle gaps as `trace.reduce` finds them, each
  labelled ``"<innermost span> | <host activity>"`` when it lies inside a
  program span. The host activity is `trace._host_label`'s, worked out
  over the host events that are not program spans. `trace.reduce` itself
  works it out over every host event, the program spans included, so the
  benchmark's breakdown names a bare span (``solver.pcg.iteration``)
  where no host operation inside the span holds the gap.

The program spans are the host annotations other than `trace.WINDOW`.
Events without a correlation id are attributed to no span.
"""

from __future__ import annotations

from collections import Counter

import torch

from benchmarks import trace as tr

SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))


def events(prof) -> list:
    """`trace._events`' (name, is_device, is_annotation, start_s, end_s) of
    every event, with its correlation id appended."""
    ids = [int(e.correlation_id())
           for e in prof.profiler.kineto_results.events()]
    return [(*e, c) for e, c in zip(tr._events(prof), ids, strict=True)]


def _open_at(spans, times) -> list:
    """For each of the sorted ``times``, the indices of the ``spans``
    ((start, end, name), sorted by start, nested) that hold it, outermost
    first."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            while stack and spans[stack[-1]][1] <= spans[k][0]:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and spans[stack[-1]][1] <= t:
            stack.pop()
        out.append(list(stack))
    return out


def reduce(evs) -> dict:
    """The spans table and labelled gaps of ``evs`` (`events`' tuples)."""
    base = tr.reduce([e[:5] for e in evs])
    windows = [(s, e) for n, dev, _, s, e, _ in evs
               if n == tr.WINDOW and not dev]
    lo, hi = windows[0]
    annotations = {n for n, dev, ann, *_ in evs if ann and not dev}
    annotations |= {tr.WINDOW, "Command Buffer Full"}
    spans = sorted(((s, e, n) for n, dev, ann, s, e, _ in evs
                    if ann and not dev and n != tr.WINDOW
                    and s < hi and e > lo), key=lambda x: (x[0], -x[1]))
    launch_at = {c: s for n, dev, _, s, _, c in evs
                 if not dev and c and n.startswith("cu")}
    ops = sorted((launch_at[c], s, e) for n, dev, _, s, e, c in evs
                 if dev and n not in annotations and c in launch_at)
    syncs = sorted(s for n, dev, _, s, _, _ in evs
                   if not dev and n in SYNCS and lo <= s < hi)

    reach = [0.0] * len(spans)  # end of the last operation launched inside
    device = [0.0] * len(spans)
    launches = [0] * len(spans)
    nsync = [0] * len(spans)
    attributed = 0.0
    for (_, s, e), held in zip(ops, _open_at(spans, [o[0] for o in ops])):
        if held:
            attributed += e - s
        for k in held:
            device[k] += e - s
            launches[k] += 1
            reach[k] = max(reach[k], e)
    ops_host = sorted((s, e, n) for n, dev, ann, s, e, _ in evs
                      if not dev and not ann and not n.startswith("cu"))
    ops_starts = [s for s, _, _ in ops_host]
    inner_syncs = Counter()
    for t, held in zip(syncs, _open_at(spans, syncs)):
        where = spans[held[-1]][2] if held else "(no span)"
        inner_syncs[f"{where} | {tr._host_label(ops_host, ops_starts, t)}"] \
            += 1
        for k in held:
            nsync[k] += 1
    table = {}
    for k, (s, e, n) in enumerate(spans):
        row = table.setdefault(n, {"count": 0, "host_s": 0.0, "wall_s": 0.0,
                                   "device_s": 0.0, "launches": 0,
                                   "syncs": 0})
        row["count"] += 1
        row["host_s"] += e - s
        row["wall_s"] += max(e, reach[k]) - s
        row["device_s"] += device[k]
        row["launches"] += launches[k]
        row["syncs"] += nsync[k]

    host = sorted((s, e, n) for n, dev, ann, s, e, _ in evs
                  if not dev and n != tr.WINDOW and not ann)
    starts = [s for s, _, _ in host]
    intervals = [(s, e) for n, dev, _, s, e, _ in evs
                 if dev and n not in annotations]
    gaps = sorted(tr.idle_gaps(intervals, lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    mids = [0.5 * (g0 + g1) for g0, g1 in gaps]
    order = sorted(range(len(mids)), key=mids.__getitem__)
    held = dict(zip(order, _open_at(spans, [mids[i] for i in order])))
    labelled = []
    for i, (g0, g1) in enumerate(gaps):
        label = tr._host_label(host, starts, mids[i])
        if held[i]:
            label = f"{spans[held[i][-1]][2]} | {label}"
        labelled.append([label, g1 - g0])
    return {"trace": base, "spans": table, "attributed_s": attributed,
            "device_op_s": sum(base.kernel_s.values()),
            "inner_syncs": dict(inner_syncs), "idle_gaps": labelled}


def capture(fn):
    """(fn's result, `reduce` of the call's trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            result = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return result, reduce(events(prof))


def per_span(table: dict, names, key: str) -> float:
    """The sum of ``key`` over the rows of ``names`` that the table has."""
    return sum(table[n][key] for n in names if n in table)
