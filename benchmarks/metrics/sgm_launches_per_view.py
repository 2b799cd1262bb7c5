"""sgm_launches_per_view (launches, program_counter; layer SGM kernels;
moves depth_mps): `sgm.cuda_agg.launches`, summed over the TPU kernel rows
and cleared before the window, divided by the window's views."""


def read(ctx):
    if not ctx.views:
        return None
    return ctx.counters["sgm_launches"] / ctx.views
