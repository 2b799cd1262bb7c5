"""The traced request's spans, as the program recorded them.

Spans (`smvs_tpu_torch.utils.timing`) are off in the window and on while
`torch.profiler` runs, so after a ``--trace 1`` run's traced request
`timing.records` holds that request's spans alone. Readers of per-layer
metrics that count or time spans divide by the request's `views`.
"""

from __future__ import annotations


def spans(ctx):
    """The traced request's span records, or None without a trace."""
    if ctx.trace is None:
        return None
    from smvs_tpu_torch.utils import timing

    return list(timing.records)


def views(records) -> int:
    """The views of a request, from its spans: one ``cli.sgm`` span a view
    in the scan driver; else (the pair driver, one view a request) one
    ``opt.view`` span a view."""
    return sum(s.name == "cli.sgm" for s in records) or sum(
        s.name == "opt.view" for s in records)
