"""depth_mps (MP/s, host clock, end to end): the input-photo megapixels of
every view whose depth map the window completed, over the window's whole
elapsed time."""


def read(ctx):
    return ctx.mp / ctx.seconds if ctx.views else None
