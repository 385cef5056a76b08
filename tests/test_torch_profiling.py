"""The port's stage spans (``utils/profiling.py:StageTimer``) on the CPU: named
in a profiler capture with their parent; timed on the stream by event pairs
that are folded in without waiting (stand-in events for the card's); the
runner's ``host_wait`` span where the host reads the device; the program
spans of a chrome trace that ``tools/profile_trace.py`` gives each device
item; and the benchmark's readers of the stream times and the wait count."""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core.config import tiny_smoke_config
from hybridgl_tpu_torch.core.params import init_clip, init_sam
from hybridgl_tpu_torch.models.sam.amg import Proposals
from hybridgl_tpu_torch.pipeline import handoff, runner
from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline, ImageSample
from hybridgl_tpu_torch.tools import profile_trace
from hybridgl_tpu_torch.utils.profiling import StageTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_spans_are_named_in_the_profiler_with_their_parent():
    t = StageTimer(device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("small_region_cleanup"):
            with t.span("host_wait"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events()}
    assert events["small_region_cleanup"].cpu_parent is None
    assert events["host_wait"].cpu_parent.name == "small_region_cleanup"
    assert events["aten::sum"].cpu_parent.name == "host_wait"
    assert dict(t.counts) == {"small_region_cleanup": 1, "host_wait": 1}  # off the card: host times alone


class _Stream:
    """A stand-in for the card's stream: ``now`` is the time (ms) at which the
    next recorded event completes, and the stream has run up to ``done``."""

    def __init__(self):
        self.now, self.done = 0.0, -1.0
        self.recorded = 0


class _Event:
    def __init__(self, stream, enable_timing=False):
        assert enable_timing
        self.stream, self.t = stream, None

    def record(self, stream=None):
        self.t = self.stream.now
        self.stream.recorded += 1

    def query(self):
        return self.t <= self.stream.done

    def elapsed_time(self, other):
        assert self.query() and other.query(), "read before it finished"
        return other.t - self.t

    def synchronize(self):
        raise AssertionError("the timer waited on an event")


@pytest.fixture
def stream(monkeypatch):
    """``torch.cuda``'s events, streams and capture state replaced by stand-ins
    that fail on any wait."""
    s = _Stream()
    s.capturing = False
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing=False: _Event(s, enable_timing))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: s)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: s.capturing)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("the timer synchronised"))
    return s


def _span_at(timer, stream, name, t0, t1, inner=None):
    """A span whose events complete at t0 and t1 (ms), ``inner`` (name, t0, t1) inside it."""
    stream.now = t0
    with timer.span(name):
        if inner is not None:
            _span_at(timer, stream, *inner)
        stream.now = t1


def test_stream_pairs_are_folded_without_waiting(stream):
    """Pairs go to ``@device`` (a nested span under its path), top-level
    spans' gaps to ``@gap``; an unfinished pair waits for a later read."""
    t = StageTimer(block=False, device="cuda")
    _span_at(t, stream, "proposals_dispatch", 0.0, 5.0)
    _span_at(t, stream, "small_region_cleanup", 7.0, 12.0, inner=("host_wait", 8.0, 9.0))
    stream.done = 9.0  # the cleanup's exit (12) has not run yet
    assert dict(t.counts) == {"proposals_dispatch": 1, "small_region_cleanup": 1, "host_wait": 1,
                              "proposals_dispatch@device": 1, "small_region_cleanup/host_wait@device": 1}
    assert t.totals["proposals_dispatch@device"] == pytest.approx(5e-3)
    assert t.totals["small_region_cleanup/host_wait@device"] == pytest.approx(1e-3)
    _span_at(t, stream, "crops+fusion", 12.5, 20.0)  # its entry folds what has finished: nothing new
    assert "small_region_cleanup@device" not in t._totals and len(t._pending) == 2
    stream.done = 20.0
    totals = dict(t.totals)
    assert totals["small_region_cleanup@device"] == pytest.approx(5e-3)
    assert totals["small_region_cleanup@gap"] == pytest.approx(2e-3)
    assert totals["crops+fusion@gap"] == pytest.approx(0.5e-3)
    assert "proposals_dispatch@gap" not in totals and "small_region_cleanup/host_wait@gap" not in totals
    top = sum(v for k, v in totals.items() if k.endswith("@gap") or (k.endswith("@device") and "/" not in k))
    assert top == pytest.approx(20e-3)  # the stream from the first entry to the last exit
    assert stream.recorded == 8 and not t._pending


def test_no_event_while_a_graph_is_captured(stream):
    """A span opened during a capture is timed on the host alone; one that
    encloses a capture is timed on the stream; nothing is queried meanwhile."""
    t = StageTimer(block=False, device="cuda")
    _span_at(t, stream, "proposals_dispatch", 0.0, 5.0)
    stream.capturing = True
    _span_at(t, stream, "crops+fusion", 6.0, 7.0)
    assert stream.recorded == 2 and len(t._pending) == 1
    stream.done = 100.0
    assert "proposals_dispatch@device" not in t.counts  # not folded during the capture
    stream.capturing = False
    stream.now = 8.0
    with t.span("sentence_stage"):
        stream.capturing = True  # a capture under way inside the span, ended before it closes
        stream.capturing = False
        stream.now = 9.0
    counts = dict(t.counts)
    assert counts["proposals_dispatch@device"] == 1 and counts["sentence_stage@device"] == 1
    assert "crops+fusion@device" not in counts and counts["crops+fusion"] == 1
    assert t.totals["sentence_stage@gap"] == pytest.approx(3e-3)  # from the last timed exit


@pytest.mark.parametrize("block,device", [(False, "cpu"), (True, "cpu"), (True, "cuda")])
def test_blocking_or_cpu_timer_records_no_event(stream, monkeypatch, block, device):
    """``block=True`` on the card, and any timer off it, keep to host times."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)  # the blocking timer's own sync
    t = StageTimer(block=block, device=device)
    _span_at(t, stream, "proposals_dispatch", 0.0, 5.0)
    stream.done = 100.0
    assert dict(t.counts) == {"proposals_dispatch": 1} and stream.recorded == 0


def test_host_wait_counts_reads_of_the_device():
    """The hand-off's wait is one ``host_wait`` an image; a survival hook's
    bundle, whose count and validity are read where the pipeline runs, adds
    one."""
    cfg = tiny_smoke_config(min_mask_region_area=4)
    gen = torch.Generator().manual_seed(0)
    pipe = HybridGLPipeline(cfg, init_sam(gen, cfg.sam), init_clip(gen, cfg.clip), device="cpu")
    rng = np.random.default_rng(0)
    C, S = cfg.canonical_size, cfg.sam.img_size
    sample = ImageSample(
        image_1024=rng.integers(0, 255, (S, S, 3)).astype(np.uint8), rh=S, rw=S,
        image_canonical=rng.integers(0, 255, (C, C, 3)).astype(np.uint8), h=C, w=C,
        gt_mask=rng.random((C, C)) > 0.5, sentences=("the left square", "a thing"),
    )

    def hook(props):
        n = max(int(props.num), 1)
        return props._replace(num=torch.tensor(n), valid=torch.arange(props.valid.shape[0]) < n)

    pipe.timer, pipe.survival_hook = StageTimer(device="cpu"), hook
    list(pipe.run_dataset([sample] * 3, pipe.init_state()))
    assert pipe.timer.counts["host_wait"] == 3 * 2


@pytest.mark.parametrize("pipeline_device,waits", [("cpu", 1), ("cuda", 0)])
def test_a_host_bundle_is_no_wait(pipeline_device, waits):
    """A bundle's count and validity read from host memory (the benchmark's
    stamp beside a pipeline on the card) is no wait; the same read where the
    pipeline runs is one."""
    timer = StageTimer(device="cpu")
    pipe = SimpleNamespace(device=torch.device(pipeline_device), _span=timer.span)
    P = 16
    z = torch.zeros(P)
    props = Proposals(torch.zeros((P, 4, 4), dtype=torch.bool), torch.zeros((P, 4)), z, z, torch.zeros((P, 2)), z,
                      torch.arange(P) < 3, num=3, overflow=0)
    got, bucket = HybridGLPipeline._read_bucket(pipe, props)
    assert (got.num, bucket) == (3, 8) and timer.counts.get("host_wait", 0) == waits


def test_rows_past_the_head_are_a_wait():
    """The host cleanup waits in ``wait()`` only for rows the prefetched head
    does not hold."""
    C, P = 64, 16
    cfg = tiny_smoke_config(min_mask_region_area=4)
    waits = []

    class Wait:
        def __enter__(self):
            waits.append(1)

        def __exit__(self, *exc):
            return False

    for n_live, want in ((handoff.PACKED_HEAD, 0), (handoff.PACKED_HEAD + 4, 1)):
        masks = torch.zeros((P, C, C), dtype=torch.bool)
        for i in range(n_live):
            masks[i, 2 * i : 2 * i + 10, 3 : 20] = True
        valid = torch.arange(P) < n_live
        z = torch.zeros(P)
        props = Proposals(masks, torch.zeros((P, 4)), z, z, torch.zeros((P, 2)), masks.sum((-2, -1)).float(),
                          valid, num=torch.tensor(n_live), overflow=torch.tensor(0))
        waits.clear()
        runner.cleanup_host(cfg, props, (C, C), "cpu", wait=Wait)
        assert len(waits) == want, n_live


def _trace(tmp_path):
    """A chrome trace: the program's spans (one opened twice, as a caller's
    range around the program's own), runtime calls inside and outside them,
    and the device items they launched, one a kernel of a replayed graph."""
    span = lambda name, ts, dur: dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, pid=1, tid=7)  # noqa: E731
    call = lambda name, ts, corr, tid=7: dict(ph="X", cat="cuda_runtime", name=name, ts=ts, dur=1,  # noqa: E731
                                              pid=1, tid=tid, args=dict(correlation=corr))
    item = lambda cat, name, corr, dur: dict(ph="X", cat=cat, name=name, ts=1000 + corr, dur=dur, pid=0, tid=9,  # noqa: E731
                                             args=dict(correlation=corr))
    events = [
        span("proposals_dispatch", 0, 50), span("proposals_dispatch", 0, 50),
        call("cudaMemcpyAsync", 2, 1), call("cudaGraphLaunch", 10, 2),
        span("small_region_cleanup", 60, 40), span("host_wait", 70, 10),
        call("cudaMemcpyAsync", 72, 3), call("cudaLaunchKernel", 90, 4),
        call("cudaLaunchKernel", 120, 5),  # outside every span
        call("cudaLaunchKernel", 30, 6, tid=8),  # another thread: no span of its own
        item("gpu_memcpy", "Memcpy HtoD", 1, 3000), item("kernel", "resident_kernel<80>", 2, 40000),
        item("kernel", "elementwise_kernel", 2, 20000), item("gpu_memcpy", "Memcpy DtoH", 3, 1000),
        item("kernel", "elementwise_kernel", 4, 2000), item("kernel", "reduce_kernel", 5, 1000),
        item("kernel", "reduce_kernel", 6, 3000),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(tmp_path), events


def test_profile_trace_gives_each_device_item_its_span(tmp_path, capsys):
    trace_dir, events = _trace(tmp_path)
    assert profile_trace.launch_spans(events) == {
        1: "proposals_dispatch", 2: "proposals_dispatch", 3: "small_region_cleanup/host_wait",
        4: "small_region_cleanup", 5: profile_trace.NO_SPAN, 6: profile_trace.NO_SPAN}
    out = profile_trace.parse(trace_dir, calls=1)
    assert out["by_span"] == pytest.approx({"proposals_dispatch": 63.0, "small_region_cleanup/host_wait": 1.0,
                                            "small_region_cleanup": 2.0, profile_trace.NO_SPAN: 4.0})
    assert out["by_span_operation"]["proposals_dispatch"]["elementwise_kernel"] == pytest.approx(20.0)
    assert "(94.3% of the device time under a span)" in capsys.readouterr().out


def _metric(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "benchmark", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# a window of 4 images as the harness copies it (seconds), and what each new reader makes of it
_TOTALS = {"proposals_dispatch": 0.016, "host_wait": 0.0004, "small_region_cleanup": 0.08, "parse+tokenize": 0.001,
           "crops+fusion": 0.004, "sentence_stage": 0.003,
           "proposals_dispatch@device": 0.160, "proposals_dispatch@gap": 0.012, "host_wait@device": 0.0001,
           "host_wait@gap": 0.0002, "small_region_cleanup@device": 0.002, "small_region_cleanup@gap": 0.0001,
           "small_region_cleanup/host_wait@device": 0.0003, "parse+tokenize@device": 0.0001,
           "parse+tokenize@gap": 0.0001, "crops+fusion@device": 0.124, "crops+fusion@gap": 0.0002,
           "sentence_stage@device": 0.020, "sentence_stage@gap": 0.0001}
_COUNTS = {"proposals_dispatch": 4, "host_wait": 5, "small_region_cleanup": 4, "parse+tokenize": 4,
           "crops+fusion": 4, "sentence_stage": 4, "small_region_cleanup/host_wait@device": 1,
           **{k: 4 for k in _TOTALS if k.endswith("@device") and "/" not in k},
           **{k: 4 for k in _TOTALS if k.endswith("@gap")}}
_COUNTS["proposals_dispatch@gap"] = 3
READINGS = {"proposal_span_device_ms": 40.0, "feature_span_device_ms": 31.0, "sentence_span_device_ms": 5.0,
            "stream_gap_ms": 1e3 * (0.0001 + 0.002 + 0.0001 + 0.012 + 0.0002 + 0.0001 + 0.0001 + 0.0002 + 0.0001) / 4,
            "host_waits_per_image": 1.25}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_span_metric_reads_the_window(name):
    run = SimpleNamespace(timer=dict(totals=dict(_TOTALS), counts=dict(_COUNTS)))
    assert _metric(name)(run) == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_span_metric_is_silent_without_the_programs_spans(name):
    """An untraced window, and a program whose spans have no stream times or
    waits (the parent's), read None; nothing raises."""
    host = {k: v for k, v in _TOTALS.items() if "@" not in k and k != "host_wait"}
    parent = SimpleNamespace(timer=dict(totals=host, counts={k: _COUNTS[k] for k in host}))
    assert _metric(name)(SimpleNamespace(timer=None)) is None
    assert _metric(name)(parent) is None


def test_benchmark_lists_the_span_metrics():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in READINGS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["workloads"] == ["refcoco-occupancy"]
        assert m["moves"] == ("image_latency_ms_p95" if name == "host_waits_per_image" else "images_per_s")
