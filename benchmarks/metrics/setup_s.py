"""setup_s (s, host clock, end to end): from the start of the process to
the first timed request: imports and the CUDA context, the SGM library
(built by nvcc on a checkout's first run), rendering the inputs, the
command line's once-a-run work and one warm-up request."""


def read(ctx):
    return ctx.setup_s
