"""sgm_s_per_view (s, program_span; layer SGM; moves depth_mps): the
harness's spans around each view's SGM call (`reconstruct_auto`, or
`cli.reconstruct_sgm`), each ending in a synchronize or a copy to the
host, summed over the window and divided by its views."""


def read(ctx):
    if not ctx.views or "sgm" not in ctx.spans:
        return None
    return ctx.spans["sgm"] / ctx.views
