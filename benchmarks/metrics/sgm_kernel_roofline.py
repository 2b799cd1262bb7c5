"""sgm_kernel_roofline (%, device_trace; layer SGM kernels; moves
depth_mps): the least time of the SGM aggregation's work over the device
time of the SGM kernels in the traced request.

The work is the algorithm's, from the configuration's pixels and planes
(not the program's plan): for each rectified pair, both directions'
[height, width, planes] int16 cost volumes read once, their 8-path sums
written once, and the int32 intensities read once. Its least time is those
bytes at the H100's 3.35 TB/s (NVIDIA's data sheet, SXM, at the 700 W
power limit; `PERF.md` gives the card's limit beside each reading). The
kernels are the device events whose names hold one of ``KERNELS``.
Nothing is read when the trace holds none of them.
"""

KERNELS = ("sgm_line_kernel", "sgm_sweep3_kernel", "sgm_path_kernel",
           "sgm_deep_kernel", "sgm_deep_sweep_kernel")
HBM_BYTES_PER_S = 3.35e12


def pair_bytes(height: int, width: int, planes: int) -> int:
    """Bytes one rectified pair's aggregation must move: two directions,
    each an int16 volume read and an int16 sum written, and int32
    intensities read."""
    per = height * width
    return 2 * (per * planes * 2 * 2 + per * 4)


def read(ctx):
    if ctx.trace is None or not ctx.traced_sgm_pairs:
        return None
    kernel_s = sum(s for name, s in ctx.trace.kernel_s.items()
                   if any(k in name for k in KERNELS))
    if kernel_s <= 0:
        return None
    work = sum(pair_bytes(*p) for p in ctx.traced_sgm_pairs)
    return 100.0 * work / HBM_BYTES_PER_S / kernel_s
