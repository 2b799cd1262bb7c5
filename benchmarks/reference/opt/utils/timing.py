"""Stage timing (port of `smvs_tpu/utils/timing.py:StageTimer`).

With ``sync_device`` set, `sync()` waits for the GPU with
`torch.cuda.synchronize` so stage boundaries are accurate; otherwise
stages overlap with queued device work and only end-to-end times mean
anything.

`host_reads` counts the solver loops' read-backs of exit flags, one per
PCG iteration ("cg") and one per Newton step ("newton"), whether a loop
serves one view or a batch; `host_reads.clear()` resets it.

`device_trace` records a block under `torch.profiler` (the counterpart
of the JAX package's `jax.profiler` trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter, defaultdict

import torch

host_reads: Counter = Counter()


class StageTimer:
    """Accumulates wall-clock per named stage; prints a report."""

    def __init__(self, sync_device: torch.device | None = None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync_device = sync_device

    def sync(self) -> None:
        if self.sync_device is not None and self.sync_device.type == "cuda":
            torch.cuda.synchronize(self.sync_device)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage timings:"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t = self.totals[name]
            c = self.counts[name]
            lines.append(f"  {name:<28s} {t:8.2f}s  ({c} calls, "
                         f"{t / max(c, 1) * 1000:7.1f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Trace the block with `torch.profiler` (the host and, when a GPU is
    present, the device) into a Chrome trace file under ``log_dir``;
    a no-op when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
