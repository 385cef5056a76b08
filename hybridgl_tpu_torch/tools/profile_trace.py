"""Capture and rank a device trace of one pipeline stage (counterpart of the
reference's tools/profile_trace.py).

    python -m hybridgl_tpu_torch.tools.profile_trace --out /tmp/trace [--stage amg|multicrop|feature|image]
    python -m hybridgl_tpu_torch.tools.profile_trace --parse /tmp/trace

``--out`` runs the stage three times under torch.profiler after a warm-up
(full width, random bf16 weights from seed 0, the AMG's quality thresholds
zeroed) and writes ``trace.json`` (a chrome trace) there; it needs a CUDA
card. ``--stage image`` is one whole ``run_image``
(``tools/device_time.py:profile_image``, which also prints its ranking).
``--parse`` reads a written trace (no card needed) and prints the device time
a call by category (kernels, copies) and by operation name.
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

    return (lambda x: feature_stage(cfg, clip_params, x[1], x[0], h, w)), [one() for _ in range(CALLS + 1)]


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for x in inputs[1:]:
                fn(x)
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    print(f"trace: {path} ({stage}, {CALLS} calls)", flush=True)
    return path


def parse(trace_dir: str, top: int = 20, calls: int = CALLS) -> dict:
    """Device time a call by category and by operation of a written trace."""
    path = trace_dir if trace_dir.endswith(".json") else os.path.join(trace_dir, "trace.json")
    if not os.path.exists(path):
        raise SystemExit(f"no trace.json under {trace_dir}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cat, ops = collections.Counter(), collections.Counter()
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms = ev["dur"] / 1e3
            cat[ev["cat"]] += ms
            ops[ev["name"][:90]] += ms
    total = sum(cat.values())
    print(f"== device: {total / calls:.1f} ms/call over {calls} calls")
    print("-- by category:")
    for k, v in cat.most_common():
        print(f"  {v / calls:8.2f} ms/call  {k}")
    print("-- top operations:")
    for k, v in ops.most_common(top):
        print(f"  {v / calls:8.2f} ms/call  {k}")
    return {"total_ms_per_call": total / calls, "by_category": dict(cat), "by_operation": dict(ops)}


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
