"""End-to-end throughput of the port on one card (counterpart of the
reference's root ``bench.py``). A tool, not a benchmark definition.

    python -m hybridgl_tpu_torch.tools.bench

Runs the full pipeline at full width (SAM ViT-H + CLIP ViT-B/16, random bf16
weights from seed 0, the AMG's quality thresholds zeroed: random weights pass
none of them) on synthetic 480x640 images through
``HybridGLPipeline.run_dataset`` and prints ONE JSON line:

    {"metric": "e2e_images_per_sec_per_chip", "value", "unit", "device",
     "power_limit_w", "realistic_survival_img_per_s", "device_ms_per_img",
     "stage_device_ms", "flops_per_img_t", "est_mfu_e2e", "est_mfu_device",
     "multicrop": {...}}

* ``value``: the median img/s over ``BENCH_REPS`` passes of ``BENCH_ITERS``
  images after ``BENCH_WARMUP`` warm-up images (every pass's rate goes to
  stderr). Random weights leave one NMS survivor an image, so this run
  scores the smallest bucket (8 slots);
* ``realistic_survival_img_per_s``: the same with a representative occupancy
  pattern, ``[21, 7, 33, 12, 48, 3, 17, 26]`` live proposals cycling per
  image, stamped through ``survival_hook``;
* ``device_ms_per_img`` and ``stage_device_ms``: device time (every kernel
  and copy) of one image and of its proposal, feature and sentence stages,
  from torch.profiler;
* ``flops_per_img_t``: the analytic model (``utils/flops.py``; audited by
  ``tools/flops_audit.py``) at the bucket the run scored; the MFU fields
  divide it by the card's peak in ``PEAK_FLOPS_BY_DEVICE``;
* ``multicrop``: the PhraseCut configuration (``AMG_PHRASECUT``, canonical
  1024) measured the same way with ``BENCH_MC_ITERS`` images (skipped with
  ``BENCH_MULTICROP_SUB=0``). ``BENCH_MULTICROP=1`` makes PhraseCut the main
  configuration instead.

Other knobs: ``BENCH_SAM`` (preset), ``BENCH_SENTENCES`` (1 or 2 an image),
``BENCH_PPB`` (decode batch). A mode that fails fails the run. Needs a CUDA
card and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ._common import card_line, require_card

SURVIVAL = [21, 7, 33, 12, 48, 3, 17, 26]  # live proposals, cycling per image


def build_record(timing: dict, flops: dict, peak: float | None, device: str, power_limit_w: float | None) -> dict:
    """The JSON record from what was measured: ``timing`` holds ``rates``
    (img/s of every pass), optionally ``realistic_rates``, ``device_ms``,
    ``stage_device_ms`` and ``multicrop`` (a finished sub-record); ``flops``
    is ``pipeline_flops_per_image``'s dict."""
    img_per_s = float(statistics.median(timing["rates"]))
    record = {"metric": "e2e_images_per_sec_per_chip", "value": round(img_per_s, 4), "unit": "img/s", "device": device,
              "power_limit_w": power_limit_w}
    if timing.get("realistic_rates"):
        record["realistic_survival_img_per_s"] = round(float(statistics.median(timing["realistic_rates"])), 4)
    device_ms = timing.get("device_ms")
    if device_ms is not None:
        record["device_ms_per_img"] = round(device_ms, 1)
    if timing.get("stage_device_ms") is not None:
        record["stage_device_ms"] = {k: round(v, 1) for k, v in timing["stage_device_ms"].items()}
    record["flops_per_img_t"] = round(flops["total"] / 1e12, 3)
    if peak:
        record["est_mfu_e2e"] = round(img_per_s * flops["total"] / peak, 4)
        if device_ms:
            record["est_mfu_device"] = round(flops["total"] / (device_ms / 1e3) / peak, 4)
    if timing.get("multicrop") is not None:
        record["multicrop"] = timing["multicrop"]
    return record


def parse_power_limit(card: str) -> float | None:
    """``NVIDIA H100 80GB HBM3, 700.00 W`` -> 700.0."""
    try:
        return float(card.split(",")[-1].strip().split()[0])
    except (ValueError, IndexError):
        return None


def _sample(rng, cfg, n_sentences: int):
    from .device_time import _sample as synthetic_sample

    sample = synthetic_sample(rng, cfg.canonical_size)
    return sample._replace(sentences=list(sample.sentences)[:n_sentences])


def _device_ms(fn) -> float:
    """Device time (every kernel and copy) of one call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / 1e3


def _stage_device_ms(pipe, sample) -> tuple[float, dict]:
    """(device ms of one run_image, {proposal, feature, sentence} device ms) on one more image."""
    whole = _device_ms(lambda: pipe.run_image(sample, pipe.init_state()))
    out, box = {}, {}
    with torch.inference_mode():
        out["proposal"] = _device_ms(lambda: box.update(props=pipe._bucket_props(pipe.propose(sample))))
        props = box["props"]
        image_c = torch.from_numpy(sample.image_canonical).to(pipe.device)
        gt = torch.from_numpy(sample.gt_mask).to(pipe.device)
        out["feature"] = _device_ms(lambda: box.update(f=pipe._feature_stage(props, image_c, sample.h, sample.w)))
        rows = [pipe._row(s) for s in sample.sentences]
        k1, k2 = min(pipe.cfg.guidance.k1, props.num), min(pipe.cfg.guidance.k2, props.num)
        out["sentence"] = _device_ms(lambda: pipe._sentence_stage(sample, props, *box["f"], rows, k1, k2, gt, pipe.init_state()))
    return whole, out


def measure(cfg, weights, tokenizer, n_warm: int, n_iter: int, n_reps: int, n_sentences: int, realistic: bool,
            log=lambda m: print(m, file=sys.stderr, flush=True)) -> tuple[dict, dict]:
    """(timing dict for :func:`build_record`, flops dict) of one configuration."""
    from ..lang import HeuristicParser
    from ..pipeline.runner import HybridGLPipeline
    from ..utils.flops import pipeline_flops_per_image

    rng = np.random.default_rng(0)
    warm = [_sample(rng, cfg, n_sentences) for _ in range(n_warm)]
    samples = [_sample(rng, cfg, n_sentences) for _ in range(n_iter)]
    timing, buckets = {}, []
    modes = [("rates", None)] + ([("realistic_rates", SURVIVAL)] if realistic else [])
    for key, survival in modes:
        pipe = HybridGLPipeline(cfg, *weights, HeuristicParser(), tokenizer, device=torch.device("cuda"))
        if survival is not None:
            counter = {"i": 0}

            def stamp(props, counter=counter, survival=survival):
                n = min(survival[counter["i"] % len(survival)], int(props.masks.shape[0]))
                counter["i"] += 1
                return props._replace(valid=torch.arange(props.masks.shape[0], device=props.valid.device) < n, num=n)

            pipe.survival_hook = stamp
        state = pipe.init_state()
        for s in warm + samples:  # warm-up: the measured samples once too
            pipe.run_image(s, state)
        rates = []
        for _ in range(n_reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for item in pipe.run_dataset(iter(samples), state, yield_props=survival is None):
                if survival is None:
                    buckets.append(pipe._bucket_props(item[2]).masks.shape[0])
            torch.cuda.synchronize()
            rates.append(n_iter / (time.perf_counter() - t0))
        timing[key] = rates
        log(f"# {key}: {[round(r, 3) for r in rates]} img/s (median {statistics.median(rates):.3f}, "
            f"{n_iter} images a pass, {n_reps} passes)")
        if survival is None:
            timing["device_ms"], timing["stage_device_ms"] = _stage_device_ms(pipe, _sample(rng, cfg, n_sentences))
    scored = int(round(statistics.mean(buckets)))
    timing["proposals_scored"] = scored
    return timing, pipeline_flops_per_image(cfg, scored, n_sentences)


def main(argv=None) -> int:
    require_card("bench")
    from ..core.config import AMG_PHRASECUT, AmgConfig, PipelineConfig
    from ..core.params import cast_tree, init_clip, init_sam
    from ..models.clip.tokenizer import default_tokenizer
    from ..utils.flops import peak_flops

    env = os.environ.get
    n_warm, n_iter, n_reps = int(env("BENCH_WARMUP", "1")), int(env("BENCH_ITERS", "8")), int(env("BENCH_REPS", "5"))
    n_sentences = int(env("BENCH_SENTENCES", "2"))
    zeroed = dict(pred_iou_thresh=0.0, stability_score_thresh=0.0)
    refcoco = PipelineConfig(sam_model=env("BENCH_SAM", "vit_h"), fusion_mode="G2L", amg=AmgConfig(**zeroed))
    phrasecut = refcoco.replace(amg=dataclasses.replace(AMG_PHRASECUT, **zeroed), canonical_size=1024)
    if env("BENCH_PPB"):
        refcoco, phrasecut = (c.replace(amg=dataclasses.replace(c.amg, points_per_batch=int(env("BENCH_PPB"))))
                              for c in (refcoco, phrasecut))
    multicrop_main = bool(env("BENCH_MULTICROP"))
    cfg = phrasecut if multicrop_main else refcoco

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    peak = peak_flops(kind)
    gen = torch.Generator(device="cuda").manual_seed(0)
    weights = cast_tree(init_sam(gen, cfg.sam), torch.bfloat16), cast_tree(init_clip(gen, cfg.clip), torch.bfloat16)
    tokenizer = default_tokenizer()

    timing, flops = measure(cfg, weights, tokenizer, n_warm, n_iter, n_reps, n_sentences, realistic=True)
    if not multicrop_main and env("BENCH_MULTICROP_SUB", "1") != "0":
        mc_iters = int(env("BENCH_MC_ITERS", str(max(n_iter // 4, 2))))
        mc_timing, mc_flops = measure(phrasecut, weights, tokenizer, n_warm, mc_iters, n_reps, n_sentences, realistic=False)
        sub = build_record(mc_timing, mc_flops, peak, kind, parse_power_limit(card))
        timing["multicrop"] = {k: v for k, v in sub.items() if k not in ("metric", "device", "power_limit_w")}
    record = build_record(timing, flops, peak, kind, parse_power_limit(card))
    print(f"# card: {card}; config {'PhraseCut' if multicrop_main else 'RefCOCO'}, iters={n_iter} reps={n_reps} "
          f"warmup={n_warm}, bucket scored {timing['proposals_scored']}", file=sys.stderr, flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
