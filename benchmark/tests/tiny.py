"""A tiny configuration and mixes with the shapes of the real ones, for the
CPU tests (test-tiny widths, 64-pixel frames, the real tokenizer)."""

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SAM = {"img_size": 64, "patch_size": 16, "encoder_width": 32, "encoder_depth": 4, "encoder_heads": 2,
       "encoder_global_idx": [1, 3], "window_size": 3, "mlp_ratio": 4.0, "prompt_dim": 16, "decoder_depth": 2,
       "decoder_heads": 2, "decoder_mlp_dim": 32, "num_multimask_outputs": 3, "iou_head_depth": 3,
       "iou_head_hidden": 16, "mask_in_chans": 8, "mask_threshold": 0.0,
       "pixel_mean": [123.675, 116.28, 103.53], "pixel_std": [58.395, 57.12, 57.375]}
CLIP = {"image_size": 32, "patch_size": 8, "vision_width": 64, "vision_layers": 3, "vision_heads": 4,
        "context_length": 16, "vocab_size": 49408, "text_width": 32, "text_heads": 2, "text_layers": 2, "embed_dim": 24}


def config(multicrop: bool = False) -> dict:
    with open(os.path.join(ROOT, "configs", "refcoco-samh-clipb16.json")) as f:
        cfg = json.load(f)
    cfg.update(sam=copy.deepcopy(SAM), clip=copy.deepcopy(CLIP), points_per_side=4, points_per_batch=8,
               min_mask_region_area=20, max_proposals=8, canonical_size=64, crop_size=32,
               gem={"img_size": 64, "depth": 2, "ss_attn_iters": 1, "ss_attn_temp": None},
               images={"long_side": [64, 64], "short_side": [40, 64], "portrait_share": 0.25, "sizes": 4,
                       "objects": [2, 3]})
    cfg["guidance"] = dict(cfg["guidance"], masking_block=1)
    cfg["max_proposals"] = 16
    if multicrop:
        cfg.update(crop_n_layers=1, crop_n_points_downscale_factor=2, max_proposals=16, max_candidates_per_crop=16,
                   images={"long_side": [48, 64], "aspect": [0.75, 1.0], "portrait_share": 0.25, "sizes": 4,
                           "objects": [2, 3]})
    return cfg


def mix(stamped: bool = True) -> dict:
    return {"cycle": 8, "expressions_per_sample": {"1": 2, "2": 2, "3": 2, "4": 2},
            "other_nouns": {"0": 0.5, "1": 0.3, "2": 0.2}, "live_proposals": [3, 5, 2, 7] if stamped else None,
            "stamp_pool": 8, "check_images": 3, "profile_images": 2, **({} if stamped else {"warm_buckets": [16]})}


def bench(workload: str = "tiny") -> dict:
    with open(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "tiny", "file": "unused", "source": "tests", "reduced": [], "why": "tests"})
    b["workloads"].append({"name": workload, "config": "tiny", "traffic": "unused", "chips": 1, "why": "tests"})
    return b


LIMITS = {k: 1e9 for k in (
    "iou_pred_err", "mask_err", "stab_err", "feat_err", "gem_err", "score_err", "pure_gap", "final_gap", "pure_pick",
    "final_topk", "iou_exact")}
