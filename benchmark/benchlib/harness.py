"""One run of one cell: set-up, the measured window, the traced tail, the
comparison, the result line.

The window drives the program's CLI path: ``HybridGLPipeline.run_dataset``
over a closed stream of samples made before it (depth 2: the runner queues
image i+1's proposal stage before image i's cleanup and scoring), and
``materialize_results`` on each image's results, as the CLI does. An image's
latency runs from its entry into ``run_dataset`` (its dispatch) to its
``materialize_results`` returning. The window ends at the first dispatch
due ``seconds`` after the first; the images already dispatched finish.

Instrumentation is instance-level and the harness's own: the pipeline's
methods are wrapped on the object to know which image is in flight, to copy
the first cycle's proposal rows and the checked images' feature buffers, and (``--trace 1``) to time each stage
with CUDA events and to name the host spans of the profiled tail.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, kernels, trace
from .config import ROOT, benchmark_file, cell, load_json, model_settings, port_config, traffic
from .flops import pipeline_flops_per_image
from .stamp import Stamp
from .traffic import Stream
from .weights import cast, clip_tree, seeded_model

FORBIDDEN = ("jax", "jaxlib", "flax", "hybridgl_tpu")
LAST = {}  # the last run's numbers by checked image, for the readings tool


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reference_models(cfg: dict, settings, seed: int, device):
    """The seeded float32 proposal model (its family's) and CLIP: one generator, the proposal model drawn first."""
    from benchref.clip import CLIP

    gen = torch.Generator(device=device).manual_seed(seed)
    sam = settings.family.reference_model(settings.sam, gen, device)
    clip = seeded_model(CLIP, settings.clip, gen, device)
    return sam, clip


def limits(workload: str) -> dict:
    path = os.path.join(ROOT, "limits", f"{workload}.json")
    return load_json(os.path.relpath(path, os.path.dirname(ROOT)))


class Instrument:
    """The wrappers on one pipeline object."""

    def __init__(self, pipe, stream: Stream, stamp, checked: set, timed: bool):
        self.pipe, self.stream, self.checked, self.timed = pipe, stream, checked, timed
        self.fifo = collections.deque()
        self.current = None
        self.saved = collections.defaultdict(dict)
        self.rows = {}  # position -> the proposal stage's rows of the first cycle's images
        self.info = collections.defaultdict(dict)
        self.events = {"proposal": [], "feature": [], "sentence": []}
        self.launched = []  # (stage, position, shape) of every stage call, in order
        self.counting = None  # a trace.Counting around the stamp, in the traced tail
        self.saving = False

        finish, launch = pipe._finish_proposals, pipe.stage.launch
        features, sentences = pipe.scorer.features, pipe.scorer.sentences

        def timed_call(kind, fn, *args):
            if not self.timed:
                return fn(*args)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            self.events[kind].append((a, b))
            return out

        def wrapped_finish(handoff, hw):
            self.current = self.fifo.popleft()
            with torch.profiler.record_function("finish"):
                return finish(handoff, hw)

        def wrapped_launch(sample):
            pos = self.fifo[-1] if self.fifo else None
            self.launched.append(("proposal", pos, (sample.h, sample.w)))
            out = timed_call("proposal", launch, sample)
            if self.saving and pos is not None and pos < len(self.stream):  # copied on the stream, read later
                num = out.num.clone() if isinstance(out.num, torch.Tensor) else out.num
                self.rows[pos] = (out.points.clone(), out.iou_preds.clone(), out.stability.clone(), out.valid.clone(),
                                  num, out.masks[:check.ROWS, : sample.h, : sample.w].clone())
            return out

        def wrapped_features(props, image_c, hw):
            pos = self.current
            self.info[pos]["bucket"] = int(props.masks.shape[0])
            self.launched.append(("feature", pos, int(props.masks.shape[0])))
            feats, gem = timed_call("feature", features, props, image_c, hw)
            if self.saving and pos in self.checked:
                self.saved[pos].update(feats=feats.clone(), gem=gem.clone(), bucket_props=props)
            return feats, gem

        def wrapped_sentences(props, feats, gem_pf, arrays, k, gt, acc):
            pos = self.current
            self.info[pos]["s_bucket"] = int(arrays[0].shape[0])
            acc_before = acc.clone() if self.saving and pos in self.checked else None
            out = timed_call("sentence", sentences, props, feats, gem_pf, arrays, k, gt, acc)
            if acc_before is not None:
                self.saved[pos].update(out=out, acc_before=acc_before, k=tuple(int(v) for v in k))
            return out

        pipe._finish_proposals = wrapped_finish
        pipe.stage.launch = wrapped_launch
        pipe.scorer.features = wrapped_features
        pipe.scorer.sentences = wrapped_sentences
        if stamp is not None:
            def hook(props):
                pos = self.current
                if self.counting is None:
                    return stamp(props, stream.spec(pos), pos)
                with self.counting.watch():
                    return stamp(props, stream.spec(pos), pos)

            pipe.survival_hook = hook

    def drive(self, positions, state, until=None, on_image=None):
        """``run_dataset`` over the samples at ``positions`` (an iterable; with
        ``until``, no position is dispatched after that time): calls
        ``on_image(position, t_dispatch, t_done, props, plain)``."""
        from hybridgl_tpu_torch.pipeline.runner import ImageSample, materialize_results

        dispatched = {}
        order = collections.deque()

        def feed():
            for pos in positions:
                now = time.perf_counter()
                if until is not None and dispatched and now >= until:
                    return
                dispatched[pos] = now
                self.fifo.append(pos)
                order.append(pos)
                yield ImageSample(*self.stream.sample(pos))

        for sample, results, props in self.pipe.run_dataset(feed(), state, yield_props=True):
            pos = order.popleft()
            with torch.profiler.record_function("materialize"):
                plain = materialize_results(results)
            t_done = time.perf_counter()
            if on_image is not None:
                on_image(pos, dispatched[pos], t_done, props, plain)


def _captures(pipe) -> int:
    return pipe.stage.captures + sum(pipe.scorer.captures.values())


class TracingTimer:
    """The program's StageTimer (``block=False``) with each span also named in the profiler."""

    def __init__(self, device):
        from hybridgl_tpu_torch.utils.profiling import StageTimer

        self.inner = StageTimer(block=False, device=device)

    def span(self, name):
        import contextlib

        @contextlib.contextmanager
        def both():
            with torch.profiler.record_function(name), self.inner.span(name):
                yield

        return both()


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float, device: str = "cuda",
        bench: dict | None = None, cfg: dict | None = None, mix: dict | None = None, lims: dict | None = None,
        on_pipeline=None) -> dict:
    """One run of a cell -> the result line's dict. ``on_pipeline(pipe)``, if
    given, sees the pipeline before the warm-up (the tests break it there)."""
    bench = bench or benchmark_file()
    w, conf = cell(bench, workload)
    cfg = cfg or load_json(conf["file"])
    mix = mix or traffic(w["traffic"])
    lims = lims if lims is not None else limits(workload)
    settings = model_settings(cfg, conf["file"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = {"imports": time.perf_counter() - t_start}
    build_s = None
    if cuda:
        from hybridgl_tpu_torch.kernels import _build

        t = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t if _build.build_seconds is not None else None

    # ---- set-up: weights, samples, the pipeline, the warm-up
    t = time.perf_counter()
    with torch.no_grad():
        sam_ref, clip_ref = reference_models(cfg, settings, seed, dev)
        dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        sam_params = cast(settings.family.program_tree(sam_ref), dtype)
        clip_params = cast(clip_tree(clip_ref), dtype)
        del sam_ref, clip_ref
    if cuda:
        torch.cuda.synchronize()
    phases["weights"], t = time.perf_counter() - t, time.perf_counter()
    stream = Stream(mix, cfg, seed, settings)
    phases["samples"], t = time.perf_counter() - t, time.perf_counter()
    from hybridgl_tpu_torch.lang import HeuristicParser
    from hybridgl_tpu_torch.models.clip.tokenizer import default_tokenizer
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline

    pipe = HybridGLPipeline(port_config(cfg, settings), sam_params, clip_params,
                            HeuristicParser(rela_right_bug=cfg["compat"]["rela_right_bug"]), default_tokenizer(),
                            device=dev)
    del sam_params, clip_params
    stamp = None
    if stream.stamped:
        stamp = Stamp(stream.sizes, cfg["canonical_size"], mix["stamp_pool"], len(stream), dev, seed)
    checked = stream.checked(mix["check_images"], seed)
    if on_pipeline is not None:  # beneath the harness's wrappers, as a fault in the program would be
        on_pipeline(pipe)
    inst = Instrument(pipe, stream, stamp, checked, timed=False)
    phases["pipeline"], t = time.perf_counter() - t, time.perf_counter()
    warm = [i for _, i in stream.keys()]
    inst.drive(warm, pipe.init_state())
    if not stream.stamped and mix.get("warm_buckets"):
        # the larger buckets that the real survivors of an image reach now and then: warmed
        # through a stamp that serves the warm-up alone (the window runs without a hook)
        warm_stamp = Stamp(stream.sizes, cfg["canonical_size"], mix["stamp_pool"], len(stream), dev, seed)
        for bucket in mix["warm_buckets"]:
            pipe.survival_hook = lambda props, b=bucket: warm_stamp(
                props, stream.spec(inst.current)._replace(live=b // 2 + 1), inst.current)
            inst.drive(warm, pipe.init_state())
        pipe.survival_hook = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["warm-up"] = time.perf_counter() - t
    captures_before = _captures(pipe)

    # ---- the window
    images = []
    state = pipe.init_state()
    inst.saving = True
    inst.timed = traced and cuda
    timer = TracingTimer(dev) if traced else None
    pipe.timer = timer
    nums_seen = []

    def on_image(pos, t0, t1, props, plain):
        info = inst.info[pos]
        if int(props.num) > 0:  # an image without proposals leaves the sticky clamp as it was
            nums_seen.append(int(props.num))
        images.append(dict(pos=pos, t_dispatch=t0, t_done=t1, bucket=info.get("bucket", 8),
                           n_sent=len(stream.sample(pos).sentences), s_bucket=info.get("s_bucket", 1)))
        if pos in checked:
            inst.saved[pos].update(plain=plain,
                                   k_expected=(min([cfg["guidance"]["k1"]] + nums_seen),
                                               min([cfg["guidance"]["k2"]] + nums_seen)))

    t_window = time.perf_counter()
    setup_s = t_window - t_start  # with the kernel build in a run that builds (``build_s``, reported apart)
    inst.drive(range(10 ** 9), state, until=t_window + seconds, on_image=on_image)
    if cuda:
        torch.cuda.synchronize()
    t_end = images[-1]["t_done"]
    window_s = t_end - images[0]["t_dispatch"]
    captures_in_window = _captures(pipe) - captures_before
    pipe.timer = None
    inst.saving = False
    stage_ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in inst.events.items()}
    inst.timed = False
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    # ---- the traced tail
    tail = None
    if traced and cuda:
        tail = _traced_tail(inst, stream, settings, cfg, mix, len(images))

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of the JAX package or JAX loaded in the measuring process: {bad}")

    # ---- free the program, then the comparison
    saved = {p: inst.saved[p] for p in checked if "plain" in inst.saved[p] and "out" in inst.saved[p]}
    rows = inst.rows
    del inst, pipe, stamp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = compare(cfg, settings, seed, dev, stream, saved, rows)
    LAST["numbers"] = numbers
    check_s = time.perf_counter() - t_check

    worst = check.reduce(numbers)
    # checked images at fault: over a limit of a worst-case number, or all of them when a run-wide mean is over its limit
    failed = sum(any(check.reduce({pos: numbers[pos]})[k] > lims[k] for k in lims if k not in check.MEAN_NUMBERS)
                 for pos in saved)
    if any(worst[k] > lims[k] for k in lims if k in check.MEAN_NUMBERS) or not numbers:
        failed = len(saved) or len(images)  # nothing judged: no image's result stands
    correct = bool(numbers) and all(worst[k] <= lims[k] for k in lims)

    # ---- metrics
    flops = [pipeline_flops_per_image(settings, im["bucket"], im["n_sent"])["total"] for im in images]
    lat = [1e3 * (im["t_done"] - im["t_dispatch"]) for im in images]
    run_data = SimpleNamespace(images=images, window_s=window_s, latencies_ms=lat, flops=flops,
                               timer=None if timer is None else dict(totals=dict(timer.inner.totals),
                                                                     counts=dict(timer.inner.counts)),
                               stage_ms=stage_ms, tail=tail, settings=settings, cfg=cfg, setup_s=setup_s)
    metrics = {}
    for m in (bench["per_layer"] if traced else bench["end_to_end"]):
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = end_to_end(m["name"], run_data) if not traced else read_metric(m["name"], run_data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": memory_peak, "power_limit_w": power_limit() if cuda else None}
    if tail is not None:
        device_info.update(busy_s=tail["busy_ms"] / 1e3, window_s=tail["wall_ms"] / 1e3)
    log(f"# {workload} seed {seed}: {len(images)} images in {window_s:.3f} s, set-up {setup_s:.3f} s "
        f"(kernel build {build_s}; " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items())
        + f"), captures in the window {captures_in_window}, comparison {check_s:.1f} s on "
        f"{len(numbers)} images, {sorted(saved)} in full; buckets {collections.Counter(im['bucket'] for im in images)}")
    if tail is not None:
        log(f"# traced tail: {tail['images']} images, stamp reads {tail['reads']}, stamp syncs {tail['syncs']}, "
            f"own kernels {tail['own_ms']:.3f} ms against a bound of {tail['bound_ms']:.3f} ms; own launches by "
            f"label {tail['launches']} (" + ("as modelled" if tail["launches_match"] else
                                            f"the model counts {tail['modelled']}: kernels_roofline left out") + ")")
    for pos, n in sorted(numbers.items()):
        if pos in checked:
            log(f"# image {pos}: " + ", ".join(f"{k} {v:.6g}" for k, v in check.reduce({pos: n}).items()))
    for k in check.NUMBERS:
        if k not in lims:
            log(f"read {k} {worst[k]!r} (not compared)")
    for k in lims:
        log(f"check {k} {worst[k]!r} limit {lims[k]!r}")
    result = {"correct": correct, "attempted": len(images), "failed": failed, "metrics": metrics,
              "device": device_info}
    if tail is not None:
        result["breakdown"] = tail["breakdown"]
    result["counts"] = {"captures_in_window": captures_in_window, "checked_images": len(saved),
                        "kernel_build_s": build_s,
                        **({"stamp_reads": tail["reads"], "stamp_syncs": tail["syncs"]} if tail else {})}
    result["checks"] = {k: {"value": worst[k], "limit": lims[k]} for k in lims}
    return result


def end_to_end(name: str, run) -> float | None:
    if name == "images_per_s":
        return len(run.images) / run.window_s
    if name == "image_latency_ms_p95":
        return float(np.percentile(run.latencies_ms, 95))
    if name == "setup_s":
        return run.setup_s
    raise KeyError(name)


def read_metric(name: str, run):
    """The per-layer metric ``name``: ``metrics/<name>.py``'s ``read(run)``."""
    path = os.path.join(ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def power_limit():
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0])
    except Exception:
        return None


def _traced_tail(inst: Instrument, stream, settings, cfg, mix, start: int) -> dict:
    """``profile_images`` more images through ``run_dataset`` under
    torch.profiler, the card drained before and after: device busy time,
    idle gaps by host span, the own kernels' time against their bound, and
    the stamp's reads and syncs."""
    from torch.profiler import ProfilerActivity, profile

    pipe = inst.pipe
    n = mix["profile_images"]
    inst.counting = trace.Counting()
    inst.launched = []
    pipe.timer = TracingTimer(pipe.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("tail"):
            inst.drive(range(start, start + n), pipe.init_state())
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    pipe.timer = None
    evs = trace.events(prof)
    items = trace.device_items(evs)
    tail_span = next(e for e in evs if e.get("ph") == "X" and e.get("name") == "tail")
    t_a, t_b = tail_span["ts"], tail_span["ts"] + tail_span["dur"]
    gaps = trace.idle_gaps(items, trace.host_spans(evs), t_a, t_b)
    launches = []
    for kind, pos, what in inst.launched:
        if kind == "proposal":
            launches += settings.family.proposal_launches(settings, _windows(settings, *what))
        else:
            launches += kernels.feature_launches(settings, what)
    own = [e for e in items if e["cat"] == "kernel" and trace.own_kernel(e["name"])]
    seen = dict(collections.Counter(trace.own_kernel(e["name"]) for e in own))
    modelled = kernels.launches_by_label(launches)
    out = dict(images=n, busy_ms=trace.busy_ms(items), wall_ms=(t_b - t_a) / 1e3,
               own_ms=sum(e["dur"] for e in own) / 1e3, bound_ms=kernels.total_bound_ms(launches),
               launches=seen, modelled=modelled, launches_match=seen == modelled,
               breakdown=trace.breakdown(items, gaps),
               reads=inst.counting.reads, syncs=inst.counting.syncs, host_wall_ms=wall_ms)
    inst.counting = None
    return out


def _windows(settings, h, w) -> list:
    """Each crop's (height, width) window in the canonical frame, the full image first."""
    from benchref.amg import crop_boxes

    boxes, _ = crop_boxes(h, w, settings.amg.crop_n_layers, settings.amg.crop_overlap_ratio)
    return [(y1 - y0, x1 - x0) for x0, y0, x1, y1 in boxes]


def compare(cfg, settings, seed, dev, stream, saved: dict, rows: dict) -> dict:
    """{position: numbers} of the checked images, and the proposal stage's rows
    of the first cycle's other images, against the reference made anew from the seed."""
    if not saved:
        return {}
    sam, clip = reference_models(cfg, settings, seed, dev)
    ref = check.Reference(sam, clip, cfg, settings)
    out = {}
    for pos, s in sorted(saved.items()):
        sample = stream.sample(pos)
        out[pos] = check.judge(ref, sample, program_output(s, stage_rows(rows.get(pos), dev), sample, dev),
                               s["k_expected"])
    for pos, r in sorted(rows.items()):
        if pos not in out:
            out[pos] = check.proposal_gaps(ref, stream.sample(pos), stage_rows(r, dev))
    return out


def stage_rows(saved, dev):
    """The live rows of the proposal stage's output as copied at its launch (the first ``check.ROWS``)."""
    if saved is None:
        return None
    points, iou, stab, valid, num, masks = saved
    n = min(int(num), masks.shape[0])
    live = torch.from_numpy(np.nonzero(valid[:n].cpu().numpy())[0])
    return check.Rows(points[live].double().cpu().numpy(), iou[live].float().cpu().numpy(),
                      stab[live].float().cpu().numpy(), masks[live.to(masks.device)].to(dev))


def program_output(s: dict, rows, sample, dev) -> check.ImageOut:
    """The timed path's outputs of one checked image, over its live proposals."""
    h, w = sample.h, sample.w
    bucket = s["bucket_props"]
    valid = np.asarray(bucket.valid.cpu().numpy() if isinstance(bucket.valid, torch.Tensor) else bucket.valid, bool)
    live = np.nonzero(valid)[0]
    slot = {int(j): i for i, j in enumerate(live)}
    live_t = torch.from_numpy(live).to(dev)
    live_masks = bucket.masks.index_select(0, live_t)[:, :h, :w].to(dev)
    boxes = bucket.boxes_xyxy.index_select(0, live_t.to(bucket.boxes_xyxy.device)).float().cpu().numpy()
    out = s["out"]
    sents = []
    for i, r in enumerate(s["plain"]):
        sents.append(check.SentenceOut(out.score[i].index_select(0, live_t.to(out.score.device)),
                                       slot.get(int(out.picks[i, 0]), -1), slot.get(int(out.picks[i, 1]), -1),
                                       (float(out.iou[i, 0]), float(out.iou[i, 1]))))
    return check.ImageOut(rows, live_masks, boxes,
                          s["feats"].index_select(0, live_t), s["gem"], sents, (s["acc_before"], out.acc), s["k"])
