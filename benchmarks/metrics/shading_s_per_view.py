"""shading_s_per_view (s, program_span; layer shading; moves depth_mps):
host seconds of the traced request's ``opt.lighting`` spans (the SH
lighting fits, every scale below 4) and ``opt.shading`` spans (the shading
term of each Gauss-Newton assembly), over the request's views. None where
the request ran no shading work (base mode)."""

from benchmarks import traced


def read(ctx):
    records = traced.spans(ctx)
    if not records:
        return None
    work = [s.seconds for s in records
            if s.name in ("opt.lighting", "opt.shading")
            and s.end_ns is not None]
    views = traced.views(records)
    if not work or not views:
        return None
    return sum(work) / views
