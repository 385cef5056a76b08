"""Tracing and stage timing (port of hybridgl_tpu/utils/profiling.py).

Every pipeline stage can be wrapped in a named span that shows up in a
torch.profiler capture, plus a light host-side stage timer for a quick
"where does the time go" summary without a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """A named range in torch.profiler captures."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler chrome trace into ``log_dir/trace.json``
    (no-op when None); device activity is traced where there is a card."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall time per named stage. ``block=True`` synchronises the
    device at the end of each span so that asynchronous launches do not hide
    the cost (only while profiling: synchronising destroys the overlap); on
    the CPU there is nothing to wait for."""

    def __init__(self, block: bool = False, device="cpu"):
        self.block = block
        self.device = torch.device(device)  # the device the timed pipeline runs on
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if self.block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1e-9
        lines = [f"{'stage':<24}{'total_s':>10}{'calls':>8}{'avg_ms':>10}{'pct':>7}"]
        for name, t in rows:
            n = self.counts[name]
            lines.append(
                f"{name:<24}{t:>10.3f}{n:>8}{1000 * t / max(n, 1):>10.2f}"
                f"{100 * t / total:>6.1f}%"
            )
        return "\n".join(lines)
