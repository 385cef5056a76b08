"""Capture and rank a device trace of one pipeline stage (counterpart of the
reference's tools/profile_trace.py).

    python -m hybridgl_tpu_torch.tools.profile_trace --out /tmp/trace [--stage amg|multicrop|feature|image]
    python -m hybridgl_tpu_torch.tools.profile_trace --parse /tmp/trace

``--out`` runs the stage three times under torch.profiler after a warm-up
(full width, random bf16 weights from seed 0, the AMG's quality thresholds
zeroed) and writes ``trace.json`` (a chrome trace) there; it needs a CUDA
card. ``--stage image`` is one whole ``run_image`` a call with the pipeline's
``StageTimer`` on, so the trace names its spans (it also prints the timer's
summary). ``--parse`` reads a written trace (no card needed) and prints the
device time a call by category (kernels, copies), by operation name, and by
program span: each device item goes to the innermost span open around the
runtime call that launched it (the trace's correlation id; a kernel of a
replayed CUDA graph to its ``cudaGraphLaunch``), with each span's top
operations.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys

import numpy as np
import torch

CALLS = 3  # timed calls in a captured trace


def _stage_fn(stage: str, sam_model: str):
    """(fn, inputs): ``fn(x)`` runs the stage on one prepared input."""
    from ..core.config import AMG_PHRASECUT, AmgConfig, PipelineConfig
    from ._common import sam_frames, sam_weights

    zeroed = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0)
    rng = np.random.default_rng(0)
    rh, rw, h, w = 768, 1024, 480, 640
    if stage in ("amg", "multicrop"):
        from ..models.sam import amg

        multicrop = stage == "multicrop"
        cfg = PipelineConfig(sam_model=sam_model, canonical_size=1024 if multicrop else 640,
                             amg=dataclasses.replace(AMG_PHRASECUT, **zeroed) if multicrop else AmgConfig(**zeroed))
        params, C = sam_weights(cfg.sam), cfg.canonical_size
        frames = sam_frames(rng, CALLS + 1, cfg.sam.img_size, rh, rw)
        if multicrop:
            canon = torch.from_numpy(rng.integers(0, 255, (C, C, 3), np.uint8)).cuda()
            return (lambda im: amg.generate_proposals_multicrop(params, im, rh, rw, canon, h, w, cfg.sam, cfg.amg, C)), frames
        return (lambda im: amg.generate_proposals(params, im, rh, rw, h, w, cfg.sam, cfg.amg, C)), frames
    # feature: crops + fusion + GEM features on a full bucket of random masks
    from ..core.params import cast_tree, init_clip
    from ..models.sam.amg import Proposals
    from ..pipeline.runner import feature_stage

    cfg = PipelineConfig(fusion_mode="G2L")
    clip_params = cast_tree(init_clip(torch.Generator(device="cuda").manual_seed(0), cfg.clip), torch.bfloat16)
    C, P = cfg.canonical_size, cfg.amg.max_proposals

    def one():
        img = torch.from_numpy(rng.integers(0, 255, (C, C, 3), np.uint8)).cuda()
        masks = torch.from_numpy(rng.random((P, C, C)) > 0.7).cuda()
        z = torch.zeros(P, device="cuda")
        return img, Proposals(masks, torch.zeros((P, 4), device="cuda"), z, z, torch.zeros((P, 2), device="cuda"), z, z > -1, P)

    return (lambda x: feature_stage(cfg, clip_params, x[1].masks, x[0], (h, w))), [one() for _ in range(CALLS + 1)]


def capture(out_dir: str, stage: str, sam_model: str) -> str:
    from torch.profiler import ProfilerActivity, profile

    from ._common import card_line, require_card

    require_card("profile_trace")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    print(f"card: {card_line()}", flush=True)
    if stage == "image":
        from ..core.config import AmgConfig, PipelineConfig
        from ..core.params import cast_tree, init_clip, init_sam
        from ..lang import HeuristicParser
        from ..models.clip.tokenizer import default_tokenizer
        from ..pipeline.runner import HybridGLPipeline
        from .device_time import _sample

        cfg = PipelineConfig(sam_model=sam_model, amg=AmgConfig(pred_iou_thresh=0.0, stability_score_thresh=0.0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        weights = cast_tree(init_sam(gen, cfg.sam), torch.bfloat16), cast_tree(init_clip(gen, cfg.clip), torch.bfloat16)
        pipe = HybridGLPipeline(cfg, *weights, HeuristicParser(), default_tokenizer(), device=torch.device("cuda"))
        samples = [_sample(np.random.default_rng(0), cfg.canonical_size) for _ in range(CALLS + 1)]
        state = pipe.init_state()
        fn, inputs = (lambda s: pipe.run_image(s, state)), samples
    else:
        fn, inputs = _stage_fn(stage, sam_model)
    with torch.inference_mode():
        fn(inputs[0])  # warm-up
        torch.cuda.synchronize()
        if stage == "image":
            from ..utils.profiling import StageTimer

            pipe.timer = StageTimer(block=False, device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for x in inputs[1:]:
                fn(x)
            torch.cuda.synchronize()
    if stage == "image":
        print(pipe.timer.summary(), flush=True)
    prof.export_chrome_trace(path)
    print(f"trace: {path} ({stage}, {CALLS} calls)", flush=True)
    return path


NO_SPAN = "(no span)"


def launch_spans(events) -> dict:
    """{correlation id: the program span path (``parent/name``) open around
    the runtime call with that id, innermost last, or ``NO_SPAN``}. Spans are
    the trace's ``user_annotation`` ranges on the call's thread; a name
    opened twice in a row (a caller's range around the program's own) is
    one step of the path."""
    by_thread = collections.defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev.get("cat") == "user_annotation":
            by_thread[(ev.get("pid"), ev.get("tid"))].append((ev["ts"], 0, ev["ts"] + ev["dur"], ev["name"]))
        elif ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {}):
            by_thread[(ev.get("pid"), ev.get("tid"))].append((ev["ts"], 1, ev["args"]["correlation"], None))
    out = {}
    for items in by_thread.values():
        items.sort(key=lambda it: (it[0], it[1], -it[2]))  # a span before a call at its start, outer spans first
        stack = []  # (end, name) of the open spans
        for ts, kind, value, name in items:
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if kind == 0:
                stack.append((value, name))
                continue
            path = [n for i, (_, n) in enumerate(stack) if i == 0 or stack[i - 1][1] != n]
            out[value] = "/".join(path) if path else NO_SPAN
    return out


def parse(trace_dir: str, top: int = 20, calls: int = CALLS) -> dict:
    """Device time a call by category, by operation and by program span of a written trace."""
    path = trace_dir if trace_dir.endswith(".json") else os.path.join(trace_dir, "trace.json")
    if not os.path.exists(path):
        raise SystemExit(f"no trace.json under {trace_dir}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = launch_spans(events)
    cat, ops = collections.Counter(), collections.Counter()
    by_span, span_ops = collections.Counter(), collections.defaultdict(collections.Counter)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms = ev["dur"] / 1e3
            cat[ev["cat"]] += ms
            ops[ev["name"][:90]] += ms
            span = spans.get(ev.get("args", {}).get("correlation"), NO_SPAN)
            by_span[span] += ms
            span_ops[span][ev["name"][:90]] += ms
    total = sum(cat.values())
    print(f"== device: {total / calls:.1f} ms/call over {calls} calls")
    print("-- by category:")
    for k, v in cat.most_common():
        print(f"  {v / calls:8.2f} ms/call  {k}")
    print("-- top operations:")
    for k, v in ops.most_common(top):
        print(f"  {v / calls:8.2f} ms/call  {k}")
    spanned = total - by_span.get(NO_SPAN, 0.0)
    print(f"-- by program span ({100 * spanned / (total or 1e-9):.1f}% of the device time under a span):")
    for k, v in by_span.most_common():
        print(f"  {v / calls:8.2f} ms/call  {k}")
        for name, t in span_ops[k].most_common(5):
            print(f"      {t / calls:8.2f} ms/call  {name}")
    return {"total_ms_per_call": total / calls, "by_category": dict(cat), "by_operation": dict(ops),
            "by_span": dict(by_span), "by_span_operation": {k: dict(v) for k, v in span_ops.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="", help="capture a trace into this directory")
    p.add_argument("--parse", default="", help="rank the operations of a captured trace directory")
    p.add_argument("--sam", default="vit_h")
    p.add_argument("--stage", default="amg", choices=["amg", "feature", "multicrop", "image"])
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--calls", type=int, default=CALLS, help="timed calls in the trace")
    args = p.parse_args(argv)
    if not args.out and not args.parse:
        p.error("pass --out and/or --parse")
    if args.out:
        capture(args.out, args.stage, args.sam)
    if args.parse:
        parse(args.parse, args.top, args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
