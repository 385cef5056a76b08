"""Device time per image of the two full-width paths, from torch.profiler.

Builds the RefCOCO and the PhraseCut pipeline as ``chip_smoke.py`` does (SAM
ViT-H + CLIP ViT-B/16, random bf16 weights from seed 0, the AMG's quality
thresholds zeroed, synthetic 480x640 images), runs one warm-up image, two
timed images (host clock around a synchronise) and one image under
torch.profiler, and prints for each path the wall time, the device time
summed over every kernel and copy, the busy share, the largest device
items, every copy by kind (device to pageable or pinned host memory, host
to device: count, bytes and device ms, from the profiler), the peak device
memory of the timed images, the reads to the host by call site (one more
image under a dispatch mode that records every device-to-host transfer
with the innermost frame of the package that asked for it) and the stream
synchronisations by call site (the same image under
``torch.cuda.set_sync_debug_mode``); then the busy share of three images
through ``run_dataset`` against the same three through ``run_image`` (the
union of the device's busy intervals over the wall, in turns). Beside them,
the proposal dispatch's host ms from the call to its return against the
device ms it queues, and, where the tree captures its proposal stage as a
CUDA graph, the capture's numbers (warm-up, capture and instantiate ms,
nodes, pool bytes) and the stage's kernel time under a replay and an eager
run (:func:`stage_graph_report`); and the scoring call of a finished bundle:
its reads and syncs by call site, its host ms to return beside the device ms
it queues, and, where the tree captures the scoring stages, each graph's
numbers (:func:`score_graph_report`). Both paths
are host bound, so a kernel's gain shows in the device time long before it
shows in ms per image. Uses only the package's public entry points, so the
same file times an older tree when copied into it. Needs a CUDA card.

    python -m hybridgl_tpu_torch.tools.device_time [refcoco] [phrasecut]   (default: both)
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

SENTENCES = ["the large brown dog on the left", "person behind the table"]
# substrings of the port's own kernels' names: listed wherever they rank
OWN_KERNELS = ("rel_pos_", "resident_kernel", "attention_kernel", "pass1_stats", "decoder_attn", "upscale_hyper",
               "nms_")
PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_events(prof) -> list:
    """The profiled device items (kernels, copies, fills) of the exported
    trace, which alone carries CUPTI's byte counts (``args.bytes``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def copies_by_kind(events) -> dict:
    """{kind: {copies, bytes, device_ms}} of the profiled copies, the kind as
    CUPTI names it ("DtoH (Device -> Pageable)", "DtoH (Device -> Pinned)",
    "HtoD (Pinned -> Device)", ...); bytes is None where no copy of the kind
    has a count."""
    kinds = collections.defaultdict(list)
    for e in events:
        if e["cat"] == "gpu_memcpy":
            kinds[e.get("name", "").replace("Memcpy ", "")].append(e)
    out = {}
    for kind, copies in sorted(kinds.items()):
        counted = [e["args"]["bytes"] for e in copies if "bytes" in e.get("args", {})]
        out[kind] = dict(copies=len(copies), bytes=sum(counted) if counted else None,
                         device_ms=sum(e["dur"] for e in copies) / 1e3)
    return out


def busy_ms(events) -> float:
    """The device's busy time: the union of its items' intervals (a copy on a
    side stream that overlaps a kernel counts once)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _describe(kind: str, c: dict) -> str:
    size = "bytes not measured" if c["bytes"] is None else f"{c['bytes']} bytes ({c['bytes'] / 1e6:.3f} MB)"
    return f"{kind}: {c['copies']} copies, {size}, {c['device_ms']:.3f} ms of device time"


def profile_image(pipe, sample, state, log=print, top_n: int = 12) -> dict:
    """One ``run_image`` under torch.profiler: {wall_ms, device_ms, launches,
    copies: copies_by_kind, dtoh_pageable and dtoh_pinned: those two kinds
    (zero copies where there were none)}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_image(sample, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_total = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"  profiled image: wall {wall:.1f} ms, device time {device_total:.1f} ms over "
        f"{launches} kernels and copies (busy share {device_total / wall:.2f}, profiler on)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    for e in top + [e for e in kernels if e not in top and any(n in e.key for n in OWN_KERNELS)]:
        log(f"  device {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    copies = copies_by_kind(_device_events(prof))
    for kind, c in copies.items():
        log(f"  copy {_describe(kind, c)}")
    none = dict(copies=0, bytes=0, device_ms=0.0)
    return dict(wall_ms=wall, device_ms=device_total, launches=launches, copies=copies,
                dtoh_pageable=copies.get("DtoH (Device -> Pageable)", none),
                dtoh_pinned=copies.get("DtoH (Device -> Pinned)", none))


def _call_site() -> str:
    """The innermost frame of the package outside this file, as path:line (function)."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.startswith(PACKAGE) and not frame.filename.endswith("device_time.py"):
            return f"{os.path.relpath(frame.filename, os.path.dirname(PACKAGE))}:{frame.lineno} ({frame.name})"
    return "outside the package"


def host_reads(fn, log=print) -> list:
    """Run ``fn()`` under a dispatch mode that records every transfer from the
    device to the host with its call site, and log them. A read is a
    transfer the host waits for (a blocking copy into a CPU tensor, a scalar
    read, a ``nonzero``'s count): [(site, transfers, bytes)], most bytes
    first. Non-blocking copies into (pinned) host memory are logged apart
    and not returned. Under ``torch.inference_mode`` (the runner's) a scalar
    read reaches the mode as ``aten.item`` or ``aten.is_nonzero``, elsewhere
    as ``aten._local_scalar_dense``: all three count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    scalar_reads = (aten._local_scalar_dense.default, aten.item.default, aten.is_nonzero.default)
    sites = {False: collections.defaultdict(lambda: [0, 0]), True: collections.defaultdict(lambda: [0, 0])}

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            src = next((a for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)
            if src is None:
                return out
            if func in scalar_reads or func is aten.nonzero.default:
                site = sites[False][_call_site()]
                site[0] += 1
                site[1] += src.element_size() if func in scalar_reads else 8  # nonzero reads its int64 count
            elif isinstance(out, torch.Tensor) and out.device.type == "cpu":
                async_copy = func is aten.copy_.default and bool(
                    args[2] if len(args) > 2 else kwargs.get("non_blocking", False))
                site = sites[async_copy][_call_site()]
                site[0] += 1
                site[1] += src.numel() * src.element_size()
            return out

    with Reads():
        fn()
    torch.cuda.synchronize()
    for async_copy, what in ((False, "reads to the host"), (True, "non-blocking copies to the host")):
        found = sorted(((k, n, b) for k, (n, b) in sites[async_copy].items()), key=lambda r: -r[2])
        total = sum(b for _, _, b in found)
        log(f"  {what} by call site (dispatch mode): {sum(n for _, n, _ in found)} transfers, "
            f"{total} bytes ({total / 1e6:.3f} MB)")
        for site, n, b in found:
            log(f"    {b:>12d} bytes  x{n:<5d} {site}")
        if not async_copy:
            reads = found
    return reads


def host_syncs(fn, log=print) -> list:
    """Run ``fn()`` with ``torch.cuda.set_sync_debug_mode("warn")``, which
    warns at every operation that makes the host wait for the stream (a read
    to the host, a blocking copy either way, a stream synchronisation), and
    log the call sites: [(site, syncs)], most first."""
    import warnings

    sites = collections.Counter()
    saved = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            sites[_call_site()] += 1
        else:
            saved(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sites.most_common()
    log(f"  stream synchronisations by call site (sync debug mode): {sum(sites.values())}")
    for site, n in syncs:
        log(f"    x{n:<5d} {site}")
    return syncs


def stage_ms(pipe, sample, log=print) -> dict:
    """One ``run_image`` with a blocking ``StageTimer`` (the device
    synchronised at the end of each span): {span: ms}. The runner's
    ``small_region_cleanup`` span is the host cleanup alone."""
    from ..utils.profiling import StageTimer

    pipe.timer = StageTimer(block=True, device="cuda")
    try:
        pipe.run_image(sample, pipe.init_state())
        out = {k: v * 1e3 for k, v in pipe.timer.totals.items()}
    finally:
        pipe.timer = None
    log("  stage wall (blocking timer): " + ", ".join(f"{k} {v:.1f} ms" for k, v in out.items()))
    return out


def dispatch_ms(pipe, sample, n: int = 5):
    """The proposal dispatch (stage + hand-off, nothing waited for) ``n``
    times, the card drained between calls: ([host ms from the call to its
    return], [device ms from the first to the last work it queued, CUDA
    events])."""
    host, device = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        pipe._dispatch_proposals(sample)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    return host, device


def _kernel_device_ms(fn) -> tuple:
    """``fn()`` under torch.profiler (device activity): (kernels, device ms,
    {kernel name: device ms} of the port's own kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in _device_events(prof) if e["cat"] == "kernel"]
    own = collections.defaultdict(float)
    for e in kernels:
        if any(k in e["name"] for k in OWN_KERNELS):
            own[e["name"][:60]] += e["dur"] / 1e3
    return len(kernels), sum(e["dur"] for e in kernels) / 1e3, dict(own)


def stage_graph_report(pipe, sample, log=print) -> dict:
    """The proposal stage as a captured graph (``pipe.stage``, a
    ``pipeline/stage_graph.py:StageGraph``; absent from older trees): its
    capture's numbers, the dispatch's host ms to return beside the device ms
    it queues (:func:`dispatch_ms`), and the stage's device time by kernel
    under a replay and under an eager run of the same stage function on the
    same inputs (the profiler may not see inside a replay; the eager run is
    the breakdown then)."""
    host, device = dispatch_ms(pipe, sample)
    out = dict(dispatch_host_ms=host, dispatch_device_ms=device)
    log(f"  proposal dispatch: host ms to return {[round(t, 3) for t in host]}, device ms queued "
        f"{[round(t, 3) for t in device]}")
    stage = getattr(pipe, "stage", None)
    if stage is None:
        log("  no captured proposal stage in this tree")
        return out
    st = stage.stats()
    out.update(st)
    replay = []
    for _ in range(5):  # the graph launch alone, on a drained card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage.graph.replay()
        replay.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out["replay_host_ms"] = replay
    log(f"  the graph's replay call alone: host ms to return {[round(t, 3) for t in replay]}")
    log(f"  stage graph: {st['captures']} capture, warm-up {st['warmup_ms']:.1f} ms, capture {st['capture_ms']:.1f} "
        f"ms, instantiate {st['instantiate_ms']:.1f} ms, {st['nodes']} nodes, pool {st['pool_bytes']} bytes "
        f"({st['pool_bytes'] / 2**30:.2f} GiB), launches a replay {st['launches']}")
    for how, fn in (("replay", lambda: stage.launch(sample)), ("eager", stage.eager)):
        n, ms, own = _kernel_device_ms(fn)
        out[f"{how}_kernels"], out[f"{how}_device_ms"] = n, ms
        seen = "" if n else " (the profiler attributes no kernel inside a replay: see the eager run)"
        log(f"  stage under {how}: {n} kernels, {ms:.1f} ms of kernel time{seen}")
        for name, t in sorted(own.items(), key=lambda kv: -kv[1]):
            log(f"    {t:8.2f} ms  {name}")
    return out


def _finished(pipe, sample):
    """One image's proposal dispatch and finish, the card drained after:
    (bundle, canonical image on the device, scoring bucket; None on trees
    whose finish gives the bundle alone)."""
    handoff, image_c = pipe._dispatch_proposals(sample)
    out = pipe._finish_proposals(handoff, (sample.h, sample.w))
    props, bucket = (out, None) if hasattr(out, "masks") else out
    torch.cuda.synchronize()
    return props, image_c, bucket


def _score(pipe, sample, finished, state):
    """``_score_image`` of a finished bundle, as ``run_image`` calls it."""
    props, image_c, bucket = finished
    return pipe._score_image(sample, props, state, image_c, **({} if bucket is None else dict(bucket=bucket)))


def score_ms(pipe, sample, n: int = 5, finished=None):
    """The scoring call (feature and sentence stages, queued) ``n`` times on
    one finished bundle, the card drained between calls: ([host ms from the
    call to its return], [device ms from the first to the last work it
    queued, CUDA events])."""
    finished = finished or _finished(pipe, sample)
    host, device = [], []
    for _ in range(n):
        state = pipe.init_state()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        _score(pipe, sample, finished, state)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    return host, device


def score_graph_report(pipe, sample, log=print) -> dict:
    """The scoring call of one finished bundle (``_score_image``, as
    ``run_image`` makes it): its reads to the host and stream
    synchronisations by call site, its host ms to return beside the device
    ms it queues (:func:`score_ms`), and, where the tree captures the
    scoring stages (``pipe.scorer``, a ``pipeline/score_graph.py:ScoreGraph``),
    each graph's warm-up, capture and instantiate ms, nodes and pool bytes."""
    finished = _finished(pipe, sample)
    fn = lambda: _score(pipe, sample, finished, pipe.init_state())  # noqa: E731
    fn()  # a warm-up: the first image of a key captures its graphs
    torch.cuda.synchronize()
    log("  the scoring call alone (feature + sentence stages of a finished bundle):")
    reads, syncs = host_reads(fn, log=log), host_syncs(fn, log=log)
    host, device = score_ms(pipe, sample, finished=finished)
    log(f"  scoring call: host ms to return {[round(t, 3) for t in host]}, device ms queued "
        f"{[round(t, 3) for t in device]}; reads {sum(n for _, n, _ in reads)}, syncs {sum(n for _, n in syncs)}")
    out = dict(reads=reads, syncs=syncs, score_host_ms=host, score_device_ms=device, graphs={})
    scorer = getattr(pipe, "scorer", None)
    if scorer is None:
        log("  no captured scoring stages in this tree")
        return out
    out["graphs"] = scorer.stats()
    for key, st in out["graphs"].items():
        log(f"  score graph {key}: warm-up {st['warmup_ms']:.1f} ms, capture {st['capture_ms']:.1f} ms, instantiate "
            f"{st['instantiate_ms']:.1f} ms, {st['nodes']} nodes, pool {st['pool_bytes']} bytes, launches a replay "
            f"{st['launches']}")
    return out


def busy_share(pipe, samples, pipelined: bool) -> dict:
    """``samples`` through ``run_dataset`` (``pipelined``) or one
    ``run_image`` an image, under torch.profiler (device activity only):
    {wall_ms, busy_ms, share}, the busy time the union of the device's items."""
    from torch.profiler import ProfilerActivity, profile

    state = pipe.init_state()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if pipelined:
            for _ in pipe.run_dataset(iter(samples), state):
                pass
        else:
            for sample in samples:
                pipe.run_image(sample, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(_device_events(prof))
    return dict(wall_ms=wall, busy_ms=busy, share=busy / wall)


def compare_busy_share(pipe, samples, log=print) -> dict:
    """:func:`busy_share` of ``samples`` through run_image and through
    run_dataset, in turns (image, dataset, dataset, image): {"run_image":
    [...], "run_dataset": [...]}."""
    out = {"run_image": [], "run_dataset": []}
    for how in ("run_image", "run_dataset", "run_dataset", "run_image"):
        out[how].append(busy_share(pipe, samples, how == "run_dataset"))
    for how, runs in out.items():
        log(f"  {how} over {len(samples)} images: busy share "
            f"{[round(r['share'], 3) for r in runs]} (busy {[round(r['busy_ms'], 1) for r in runs]} ms of wall "
            f"{[round(r['wall_ms'], 1) for r in runs]} ms; profiler on, device activity only)")
    return out


def _sample(rng, canonical, h=480, w=640, rh=768, rw=1024):
    from ..pipeline.runner import ImageSample

    img1024 = np.zeros((1024, 1024, 3), np.uint8)
    img1024[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((canonical, canonical, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    gt = np.zeros((canonical, canonical), bool)
    gt[100:300, 150:400] = True
    return ImageSample(img1024, rh, rw, imgc, h, w, gt, SENTENCES)


def main(argv=None) -> int:
    argv = [a.lower() for a in (sys.argv[1:] if argv is None else argv)]
    if not torch.cuda.is_available():
        print("device_time: no CUDA card; nothing was timed", file=sys.stderr)
        return 2
    from ..core.config import AMG_PHRASECUT, AMG_REFCOCO, PipelineConfig
    from ..core.params import cast_tree, init_clip, init_sam
    from ..lang import HeuristicParser
    from ..models.clip.tokenizer import default_tokenizer
    from ..pipeline.runner import HybridGLPipeline

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    weights = cast_tree(init_sam(gen, base.sam), torch.bfloat16), cast_tree(init_clip(gen, base.clip), torch.bfloat16)
    for tag, amg, canonical in (("RefCOCO", AMG_REFCOCO, 640), ("PhraseCut", AMG_PHRASECUT, 1024)):
        if argv and tag.lower() not in argv:
            continue
        cfg = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16", fusion_mode="G2L", canonical_size=canonical,
                             amg=dataclasses.replace(amg, pred_iou_thresh=0.0, stability_score_thresh=0.0))
        pipe = HybridGLPipeline(cfg, *weights, HeuristicParser(), default_tokenizer(), device=torch.device("cuda"))
        rng = np.random.default_rng(0)
        samples = [_sample(rng, canonical) for _ in range(7)]
        state = pipe.init_state()
        times = []
        for i, sample in enumerate(samples[:3]):  # the first is the warm-up
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_image(sample, state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{tag}: ms/img {[round(t, 1) for t in times[1:]]} after a warm-up of {times[0]:.1f} ms, peak device "
              f"memory {torch.cuda.max_memory_allocated()} bytes "
              f"({torch.cuda.max_memory_allocated() / 2**30:.2f} GiB) allocated, "
              f"{torch.cuda.memory_reserved()} bytes reserved", flush=True)
        say = lambda m: print(m, flush=True)  # noqa: E731
        profile_image(pipe, samples[3], state, log=say)
        host_reads(lambda: pipe.run_image(samples[3], state), log=say)
        host_syncs(lambda: pipe.run_image(samples[3], state), log=say)
        stage_ms(pipe, samples[3], log=say)
        if hasattr(pipe, "_dispatch_proposals"):  # the stage's launch and hand-off alone
            say("  the proposal dispatch alone:")
            host_reads(lambda: pipe._dispatch_proposals(samples[3]), log=say)
            host_syncs(lambda: pipe._dispatch_proposals(samples[3]), log=say)
            stage_graph_report(pipe, samples[3], log=say)
            score_graph_report(pipe, samples[3], log=say)
        compare_busy_share(pipe, samples[4:7], log=say)
    return 0


if __name__ == "__main__":
    sys.exit(main())
