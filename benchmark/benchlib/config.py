"""Cells, configurations and traffic mixes, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; a
configuration is ``configs/<name>.json`` (its ``file`` entry), a traffic mix
``traffic/<name>.json``, a per-layer metric ``metrics/<name>.py``. Nothing
here knows a particular cell.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from benchref.spec import clip_spec, sam_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
REPO = os.path.dirname(ROOT)

AMG_KEYS = ("points_per_side", "points_per_batch", "pred_iou_thresh", "stability_score_thresh",
            "stability_score_offset", "box_nms_thresh", "crop_n_layers", "crop_nms_thresh", "crop_overlap_ratio",
            "crop_n_points_downscale_factor", "min_mask_region_area", "max_proposals", "max_candidates_per_crop")


def benchmark_file() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str):
    """(the workload entry, its configuration entry) of ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            conf = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, conf
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_json(relpath: str) -> dict:
    with open(os.path.join(REPO, relpath)) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(os.path.join(ROOT, "traffic", f"{name}.json")) as f:
        return json.load(f)


def amg_settings(cfg: dict) -> dict:
    return {k: cfg[k] for k in AMG_KEYS}


def model_settings(cfg: dict) -> SimpleNamespace:
    """The configuration as attributes (``.sam``, ``.clip``, ``.amg``, ``.gem``,
    ``.guidance``, ``.compat`` and the top-level settings): what the
    reference, the FLOP model and the kernel table read."""
    clip = clip_spec(cfg["clip"])
    clip.num_patches = clip.grid * clip.grid
    return SimpleNamespace(
        sam=sam_spec(cfg["sam"]), clip=clip, amg=SimpleNamespace(**amg_settings(cfg)),
        gem=SimpleNamespace(**cfg["gem"]), guidance=SimpleNamespace(**cfg["guidance"]),
        compat=SimpleNamespace(**cfg["compat"]), fusion_mode=cfg["fusion_mode"],
        canonical_size=cfg["canonical_size"], crop_size=cfg["crop_size"], blur_ksize=cfg["blur_ksize"])


def port_config(cfg: dict):
    """The measured program's ``PipelineConfig`` of a configuration file."""
    from hybridgl_tpu_torch.core.config import (AmgConfig, ClipConfig, CompatConfig, GemConfig, GuidanceConfig,
                                                PipelineConfig, SamConfig)

    sam = dict(cfg["sam"])
    for k in ("encoder_global_idx", "pixel_mean", "pixel_std"):
        sam[k] = tuple(sam[k])
    return PipelineConfig(
        clip_config=ClipConfig(**cfg["clip"]), sam_config=SamConfig(**sam), fusion_mode=cfg["fusion_mode"],
        canonical_size=cfg["canonical_size"], crop_size=cfg["crop_size"], blur_ksize=cfg["blur_ksize"],
        amg=AmgConfig(**amg_settings(cfg)), gem=GemConfig(**cfg["gem"]), guidance=GuidanceConfig(**cfg["guidance"]),
        compat=CompatConfig(**cfg["compat"]), compute_dtype=cfg["compute_dtype"])
