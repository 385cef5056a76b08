"""Stage timing and tracing (port of hybridgl_tpu/utils/profiling.py).

The pipeline wraps each stage in a named :class:`StageTimer` span. A span is
a ``torch.profiler.record_function`` range of its name, so any profiler
capture names the work launched inside it; its host wall time is summed by
name; and on the card it is also timed on the stream by CUDA events, which
are read later without waiting.

Inside a stage that runs as a CUDA graph the host is not there at replay, so
:func:`device_span` marks a part of the stage function by a pair of timing
events recorded into the graph at its capture (``external=True``: event
record nodes, re-recorded by every replay). The graph's owner hands the pairs
to the timer after each replay (:func:`replayed`), which folds them, without
waiting, as ``<the open span's key>/<name>@device``; before the graph replays
again (:func:`before_replay`) a pair that has not finished is counted as
``span_missed`` and dropped, since the replay would overwrite it. Off a
capture a device span records nothing.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

import torch

# per thread: ``timers``, the StageTimers with a span open (innermost last), and ``recorder``
_local = threading.local()


def _open_timers() -> list:
    if not hasattr(_local, "timers"):
        _local.timers = []
    return _local.timers


class GraphSpans:
    """The device spans of one captured CUDA graph: (name, entry event, exit
    event) in capture order, and the timer that holds the last replay's
    pairs unread (None: no one)."""

    def __init__(self):
        self.pairs: list = []
        self.holder: Optional["StageTimer"] = None


@contextlib.contextmanager
def recording(spans: GraphSpans) -> Iterator[GraphSpans]:
    """Around a graph's capture (its eager warm-up included): the device
    spans of the captured work go into ``spans``."""
    prev = getattr(_local, "recorder", None)
    _local.recorder = spans
    try:
        yield spans
    finally:
        _local.recorder = prev


@contextlib.contextmanager
def device_span(name: str) -> Iterator[None]:
    """A part of a stage function timed on the device: in a capture under
    :func:`recording`, an external timing event pair recorded into the graph;
    nothing elsewhere (the eager warm-up, an eager stage), so that the host
    spans stay the reference's stages."""
    rec = getattr(_local, "recorder", None)
    if rec is None or not torch.cuda.is_current_stream_capturing():
        yield
        return
    entry = torch.cuda.Event(enable_timing=True, external=True)
    exit_ = torch.cuda.Event(enable_timing=True, external=True)
    entry.record()
    yield
    exit_.record()
    rec.pairs.append((name, entry, exit_))


def before_replay(spans: GraphSpans) -> None:
    """Before a graph replays: the timer holding its last replay's pairs
    folds those that have finished and counts the others as missed."""
    if spans.holder is not None:
        spans.holder._settle(spans)


def replayed(spans: GraphSpans) -> None:
    """After a graph replayed: its pairs go to the innermost timer with a
    span open on this thread, if it times the stream."""
    timers = _open_timers()
    if timers and timers[-1]._on_stream:
        timers[-1]._take(spans)


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
    event is recorded or queried while a CUDA graph capture is under way.
    A replayed graph's device spans (module docstring) fold into
    ``<key>/<name>@device`` too; ``counts["span_missed"]`` counts the pairs
    that had not finished when their graph replayed again."""

    def __init__(self, block: bool = False, device="cpu"):
        self.block = block
        self.device = torch.device(device)  # the device the timed pipeline runs on
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._on_stream = not block and self.device.type == "cuda"
        self._open: List[str] = []  # names of the open spans, outermost first
        self._pending = deque()  # (key, entry, exit, previous top-level exit or None), in order
        self._last_exit = None  # the previous top-level span's exit event
        self._graph_pending: list = []  # (GraphSpans, key, entry, exit) of replayed graphs

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

    def _take(self, spans: GraphSpans) -> None:
        """A replay's device spans, nested under the innermost open span."""
        prefix = "/".join(self._open)
        self._graph_pending += [(spans, f"{prefix}/{name}", a, b) for name, a, b in spans.pairs]
        spans.holder = self

    def _settle(self, spans: GraphSpans) -> None:
        """Fold ``spans``' pairs that have finished; count the rest missed."""
        keep = []
        for item in self._graph_pending:
            if item[0] is not spans:
                keep.append(item)
            elif item[3].query():
                self._add(item[1], item[2], item[3])
            else:
                self._counts["span_missed"] += 1
        self._graph_pending = keep
        spans.holder = None

    def _add(self, key: str, entry, exit_) -> None:
        self._totals[key + "@device"] += entry.elapsed_time(exit_) / 1e3
        self._counts[key + "@device"] += 1

    def _fold(self) -> None:
        """Fold in the event pairs that have finished, oldest first; stop at
        the first that has not (a replayed graph's pairs: each that has)."""
        if not (self._pending or self._graph_pending) or torch.cuda.is_current_stream_capturing():
            return
        waiting = []
        for item in self._graph_pending:
            if item[3].query():
                self._add(*item[1:])
            else:
                waiting.append(item)
        self._graph_pending = waiting
        while self._pending:
            key, entry, exit_, prev = self._pending[0]
            if not exit_.query():  # stream order: its entry and the previous exit have finished with it
                return
            self._pending.popleft()
            self._add(key, entry, exit_)
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
        _open_timers().append(self)
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
            _open_timers().pop()
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
