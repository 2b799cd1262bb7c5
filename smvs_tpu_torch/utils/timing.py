"""Stage timing (port of `smvs_tpu/utils/timing.py:StageTimer`).

With ``sync_device`` set, `sync()` waits for the GPU with
`torch.cuda.synchronize` so stage boundaries are accurate; otherwise
stages overlap with queued device work and only end-to-end times mean
anything.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
