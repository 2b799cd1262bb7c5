"""device_idle_share (%, device_trace; layer device; moves depth_mps): one
minus the union of kernel and copy intervals over the traced window (one
request after the window, under `torch.profiler`), in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
