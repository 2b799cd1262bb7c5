"""host_reads_per_view (reads, program_counter; layer solver; moves
depth_mps): `utils.timing.host_reads`, the solver loops' read-backs of
their exit flags ("cg", one per PCG iteration, plus "newton", one per
Newton step; one serves every view of a batch), cleared before the
window, divided by the window's views."""


def read(ctx):
    if not ctx.views:
        return None
    return ctx.counters["host_reads"] / ctx.views
