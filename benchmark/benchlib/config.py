"""Cells, configurations, traffic mixes and model families, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; a
configuration is ``configs/<name>.json`` (its ``file`` entry), a traffic mix
``traffic/<name>.json``, a per-layer metric ``metrics/<name>.py``, and the
proposal model's family, the configuration's top-level ``sam_family``
(``families.DEFAULT`` where it has none), ``families/<family>.py``. Nothing
here knows a particular cell or family.

A family's adapter module provides, for the configuration's ``sam`` group:

* ``spec(sam) -> settings``: the reference's settings (attributes), with at
  least ``img_size`` (the frame's side) and ``mask_threshold``;
* ``reference_model(spec, generator, device) -> nn.Module``: the seeded
  float32 reference model, drawn from the run's one generator before CLIP
  (``weights.seeded_model`` draws every parameter; a module with an ``eps`` is
  drawn as a normalisation layer);
* ``program_tree(model) -> dict``: the same weights in the program's
  parameter layout, before the cast to the serving dtype;
* ``program_config(sam)``: the program's config of the model (the
  ``sam_config`` of its ``PipelineConfig``);
* ``frame(spec, image) -> (frame [S, S, 3], rh, rw)``: the image in the
  model's frame, its content in ``[:rh, :rw]``; a uint8 array (the sample's
  frame, which the program is handed) stays uint8, a tensor on the device (a
  crop, in the reference) is resized in float32;
* ``encode(model, frame, rh, rw) -> embedding``: the reference's image
  embedding of a frame (opaque to the mask generator: what ``decode`` takes);
* ``decode(model, embedding, coords [n, 2]) -> (logits [n, 3, 4g, 4g], iou [n, 3])``:
  single-point prompts in the frame's coordinates, multimask;
* ``to_crop(spec, logits, (rh, rw), (crop_h, crop_w)) -> logits at the crop's size``;
* ``encoder_flops(spec)``, ``decode_flops(spec, n_points)``: the FLOP model of
  one encoder pass and of ``n_points`` prompts (``flops.py``);
* ``proposal_launches(settings, windows) -> [(kernel, shapes)]``: the port's
  own kernel launches of one image's proposal stage (``kernels.py``).

The grids, crop boxes, NMS, stability and cleanup (``benchref/amg.py``),
CLIP, the sentence stage, the fp8 control and the comparison are shared.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

from benchref.spec import clip_spec

from . import families

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


def model_settings(cfg: dict, file: str | None = None) -> SimpleNamespace:
    """The configuration as attributes (``.family``, the adapter module;
    ``.sam``, its spec; ``.clip``, ``.amg``, ``.gem``, ``.guidance``, ``.compat``
    and the top-level settings): what the reference, the FLOP model and the
    kernel table read. ``file``, the configuration's, is named if its family is not found."""
    family = families.load(cfg, file)
    clip = clip_spec(cfg["clip"])
    clip.num_patches = clip.grid * clip.grid
    return SimpleNamespace(
        family=family, sam=family.spec(cfg["sam"]), clip=clip, amg=SimpleNamespace(**amg_settings(cfg)),
        gem=SimpleNamespace(**cfg["gem"]), guidance=SimpleNamespace(**cfg["guidance"]),
        compat=SimpleNamespace(**cfg["compat"]), fusion_mode=cfg["fusion_mode"],
        canonical_size=cfg["canonical_size"], crop_size=cfg["crop_size"], blur_ksize=cfg["blur_ksize"])


def port_config(cfg: dict, settings: SimpleNamespace):
    """The measured program's ``PipelineConfig`` of a configuration file
    (``settings``, its ``model_settings``, gives the family)."""
    from hybridgl_tpu_torch.core.config import (AmgConfig, ClipConfig, CompatConfig, GemConfig, GuidanceConfig,
                                                PipelineConfig)

    return PipelineConfig(
        clip_config=ClipConfig(**cfg["clip"]), sam_config=settings.family.program_config(cfg["sam"]),
        fusion_mode=cfg["fusion_mode"],
        canonical_size=cfg["canonical_size"], crop_size=cfg["crop_size"], blur_ksize=cfg["blur_ksize"],
        amg=AmgConfig(**amg_settings(cfg)), gem=GemConfig(**cfg["gem"]), guidance=GuidanceConfig(**cfg["guidance"]),
        compat=CompatConfig(**cfg["compat"]), compute_dtype=cfg["compute_dtype"])
