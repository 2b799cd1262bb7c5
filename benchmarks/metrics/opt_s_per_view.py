"""opt_s_per_view (s, program_span; layer optimizer; moves depth_mps): the
harness's spans around each request's `optimize_view` or
`optimize_view_batch` call and the copy of its depth maps to the host,
summed over the window and divided by its views."""


def read(ctx):
    if not ctx.views or "opt" not in ctx.spans:
        return None
    return ctx.spans["opt"] / ctx.views
