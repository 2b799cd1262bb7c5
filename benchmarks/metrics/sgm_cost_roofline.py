"""sgm_cost_roofline (%, device_trace; layer SGM; moves depth_mps): the
least time of the rectified sweep's cost volumes over the device time of
the census and cost kernels in the traced request.

The work is the algorithm's, from the configuration's pixels and planes:
for each rectified pair, both directions' [height, width, planes] int16
cost volumes written once. Its least time is those bytes at the H100's
3.35 TB/s (NVIDIA's data sheet, SXM, at the 700 W power limit; `PERF.md`
gives the card's limit beside each reading). The kernels are the device
events whose names hold one of ``KERNELS``. Nothing is read when the
trace holds none of them, as where the cost volume is built with
PyTorch's own ops.
"""

KERNELS = ("census_kernel", "census_cost_kernel")
HBM_BYTES_PER_S = 3.35e12


def pair_bytes(height: int, width: int, planes: int) -> int:
    """Bytes one rectified pair's cost volumes must move: two directions,
    each an int16 volume written."""
    return 2 * height * width * planes * 2


def read(ctx):
    if ctx.trace is None or not ctx.traced_sgm_pairs:
        return None
    kernel_s = sum(s for name, s in ctx.trace.kernel_s.items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    work = sum(pair_bytes(*p) for p in ctx.traced_sgm_pairs)
    return 100.0 * work / HBM_BYTES_PER_S / kernel_s
