"""pcg_passes_per_view (passes, program_counter; layer solver; moves
depth_mps): the traced request's ``solver.pcg.iteration`` spans, one a PCG
pass whether launched op by op or replayed from the solve's CUDA graph,
over the request's views. The views and their work are fixed, so a cell
reads the same value run after run."""

from benchmarks import traced


def read(ctx):
    records = traced.spans(ctx)
    if not records:
        return None
    views = traced.views(records)
    if not views:
        return None
    return sum(s.name == "solver.pcg.iteration" for s in records) / views
