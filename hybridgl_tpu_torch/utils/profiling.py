"""Stage timing and tracing (port of hybridgl_tpu/utils/profiling.py).

The pipeline wraps each stage in a named :class:`StageTimer` span. A span is
a ``torch.profiler.record_function`` range of its name, so any profiler
capture names the work launched inside it; its host wall time is summed by
name; and on the card it is also timed on the stream by CUDA events, which
are read later without waiting.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List

import torch


class StageTimer:
    """Accumulates the wall time of each named span, seconds, in ``totals``
    and the spans in ``counts``. ``block=True`` synchronises the device at the
    end of each span so that asynchronous launches do not hide the cost (only
    while profiling: synchronising destroys the overlap); on the CPU there is
    nothing to wait for.

    On a CUDA device with ``block=False`` each span also records a timing
    event on the current stream at its entry and at its exit. Finished pairs
    are folded in without waiting (``Event.query`` only) at the next span's
    entry and whenever ``totals`` or ``counts`` are read, as seconds:
      * ``<key>@device``: the stream's time from the span's entry to its exit
        (the work it queued, and any time the stream sat empty meanwhile);
      * ``<name>@gap``, for a top-level span: the stream's time from the
        previous top-level span's exit to this one's entry (work queued
        outside any span, and time the stream sat empty between spans).
    The key of a top-level span is its name; a nested span's is its path,
    ``parent/name``. The top-level spans' ``@device`` and ``@gap`` add up to
    the stream's time from the first span's entry to the last one's exit. No
    event is recorded or queried while a CUDA graph capture is under way."""

    def __init__(self, block: bool = False, device="cpu"):
        self.block = block
        self.device = torch.device(device)  # the device the timed pipeline runs on
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._on_stream = not block and self.device.type == "cuda"
        self._open: List[str] = []  # names of the open spans, outermost first
        self._pending = deque()  # (key, entry, exit, previous top-level exit or None), in order
        self._last_exit = None  # the previous top-level span's exit event

    @property
    def totals(self) -> Dict[str, float]:
        self._fold()
        return self._totals

    @property
    def counts(self) -> Dict[str, int]:
        self._fold()
        return self._counts

    @staticmethod
    def _event(stream):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _fold(self) -> None:
        """Fold in the event pairs that have finished, oldest first; stop at
        the first that has not."""
        if not self._pending or torch.cuda.is_current_stream_capturing():
            return
        while self._pending:
            key, entry, exit_, prev = self._pending[0]
            if not exit_.query():  # stream order: its entry and the previous exit have finished with it
                return
            self._pending.popleft()
            self._totals[key + "@device"] += entry.elapsed_time(exit_) / 1e3
            self._counts[key + "@device"] += 1
            if prev is not None:
                self._totals[key + "@gap"] += prev.elapsed_time(entry) / 1e3
                self._counts[key + "@gap"] += 1

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        timed = self._on_stream and not torch.cuda.is_current_stream_capturing()
        if timed:
            self._fold()
        top, key = not self._open, "/".join(self._open + [name])
        self._open.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                if timed:  # exit is recorded on the stream of the entry
                    stream = torch.cuda.current_stream(self.device)
                    entry = self._event(stream)
                yield
                if timed and not torch.cuda.is_current_stream_capturing():
                    exit_ = self._event(stream)
                    self._pending.append((key, entry, exit_, self._last_exit if top else None))
                    if top:
                        self._last_exit = exit_
        finally:
            self._open.pop()
        if self.block and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._totals[name] += time.perf_counter() - t0
        self._counts[name] += 1

    def summary(self) -> str:
        """The host table (the reference's, over the host spans), then, where
        the spans were timed on the stream, stream and gap ms a span."""
        totals, counts = self.totals, self.counts
        host = {k: v for k, v in totals.items() if "@" not in k}
        rows = sorted(host.items(), key=lambda kv: -kv[1])
        total = sum(host.values()) or 1e-9
        lines = [f"{'stage':<24}{'total_s':>10}{'calls':>8}{'avg_ms':>10}{'pct':>7}"]
        for name, t in rows:
            n = counts[name]
            lines.append(
                f"{name:<24}{t:>10.3f}{n:>8}{1000 * t / max(n, 1):>10.2f}"
                f"{100 * t / total:>6.1f}%"
            )
        stream = sorted(((k[: -len("@device")], v) for k, v in totals.items() if k.endswith("@device")),
                        key=lambda kv: -kv[1])
        if stream:
            lines.append(f"{'stage on the stream':<40}{'calls':>8}{'stream_ms':>11}{'gap_ms':>9}")
            for key, t in stream:
                n, gap = counts[key + "@device"], key + "@gap"
                gap_ms = f"{1000 * totals[gap] / counts[gap]:>9.2f}" if counts.get(gap) else f"{'':>9}"
                lines.append(f"{key:<40}{n:>8}{1000 * t / max(n, 1):>11.2f}{gap_ms}")
        return "\n".join(lines)
