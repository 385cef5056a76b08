"""The port's own copy of ``hybridgl_tpu/core/config.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package; the port
adds one CLIP preset, ``ViT-L/14@336``.

Typed configuration for the whole framework.

The reference scatters its knobs across hardcoded constants
(reference: Hybridgl_main.py:19,57-63,68-74,128,211-216 and
Hybridgl_main_PhraseCut.py:56-62). Here every knob lives in one frozen
dataclass tree so a run is fully described by a single `PipelineConfig`.

All dataclasses are frozen + hashable so they can be passed as static
arguments to `jax.jit`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClipConfig:
    """CLIP model hyperparameters (vision ViT + text transformer).

    Mirrors the shape-derived construction of the reference's
    ``build_model`` (reference: third_party/modified_CLIP/clip/model.py:474-503)
    but as explicit static config.
    """

    # vision
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    # joint
    embed_dim: int = 512

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS


def clip_preset(name: str) -> ClipConfig:
    presets = {
        "ViT-B/16": ClipConfig(),
        "ViT-B/32": ClipConfig(patch_size=32),
        # miniature model for CI / smoke runs (not a real checkpoint shape)
        "test-tiny": ClipConfig(
            image_size=32,
            patch_size=8,
            vision_width=64,
            vision_layers=3,
            vision_heads=4,
            context_length=16,
            vocab_size=101,
            text_width=32,
            text_heads=2,
            text_layers=2,
            embed_dim=24,
        ),
        "ViT-L/14": ClipConfig(
            patch_size=14,
            vision_width=1024,
            vision_layers=24,
            vision_heads=16,
            text_width=768,
            text_heads=12,
            text_layers=12,
            embed_dim=768,
        ),
        # the port's addition: OpenAI's ViT-L/14 at 336 px (openai/CLIP clip.py _MODELS
        # "ViT-L/14@336px"; Radford et al. 2021, Table 20): a 24 x 24 grid, 577 tokens
        "ViT-L/14@336": ClipConfig(
            image_size=336,
            patch_size=14,
            vision_width=1024,
            vision_layers=24,
            vision_heads=16,
            text_width=768,
            text_heads=12,
            text_layers=12,
            embed_dim=768,
        ),
    }
    if name not in presets:
        raise ValueError(f"unknown CLIP preset {name!r}; have {sorted(presets)}")
    return presets[name]


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SamConfig:
    """SAM hyperparameters (image encoder + prompt encoder + mask decoder).

    Mirrors the reference's construction constants
    (reference: third_party/segment-anything/segment_anything/build_sam.py:14-101).
    """

    img_size: int = 1024
    patch_size: int = 16
    encoder_width: int = 768
    encoder_depth: int = 12
    encoder_heads: int = 12
    encoder_global_idx: Tuple[int, ...] = (2, 5, 8, 11)
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden: int = 256
    mask_in_chans: int = 16
    mask_threshold: float = 0.0
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)

    @property
    def embed_grid(self) -> int:
        return self.img_size // self.patch_size  # 64

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


def sam_preset(name: str) -> SamConfig:
    presets = {
        "vit_b": SamConfig(),
        "vit_l": SamConfig(
            encoder_width=1024,
            encoder_depth=24,
            encoder_heads=16,
            encoder_global_idx=(5, 11, 17, 23),
        ),
        "vit_h": SamConfig(
            encoder_width=1280,
            encoder_depth=32,
            encoder_heads=16,
            encoder_global_idx=(7, 15, 23, 31),
        ),
    }
    presets["default"] = presets["vit_h"]
    # miniature model for CI / smoke runs (not a real checkpoint shape)
    presets["test-tiny"] = SamConfig(
        img_size=64,
        encoder_width=32,
        encoder_depth=4,
        encoder_heads=2,
        encoder_global_idx=(1, 3),
        window_size=3,
        prompt_dim=16,
        decoder_heads=2,
        decoder_mlp_dim=32,
        iou_head_hidden=16,
        mask_in_chans=8,
    )
    if name not in presets:
        raise ValueError(f"unknown SAM preset {name!r}; have {sorted(presets)}")
    return presets[name]


# ---------------------------------------------------------------------------
# Automatic mask generation (AMG)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AmgConfig:
    """Proposal-engine knobs.

    Reference defaults per dataset: RefCOCO (reference: Hybridgl_main.py:68-74)
    uses pps=8 / iou .7 / stability .7 / min_area 800; PhraseCut
    (reference: Hybridgl_main_PhraseCut.py:56-62) uses pps=64 / .86 / .92 /
    crop_n_layers=1 / min_area 100.

    TPU-specific additions: ``max_proposals`` is the static proposal bucket
    every downstream stage is padded to, and ``points_per_batch`` bounds the
    decoder batch (the whole grid is decoded in fixed-size chunks under one
    jit).
    """

    points_per_side: int = 8
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.7
    stability_score_thresh: float = 0.7
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    crop_n_layers: int = 0
    crop_nms_thresh: float = 0.7
    crop_overlap_ratio: float = 512 / 1500
    crop_n_points_downscale_factor: int = 1
    min_mask_region_area: int = 800
    # static shape discipline
    max_proposals: int = 64
    # per-crop survivor bucket for the multi-crop path (crop_n_layers >= 1)
    max_candidates_per_crop: int = 256


AMG_REFCOCO = AmgConfig()
AMG_PHRASECUT = AmgConfig(
    points_per_side=64,
    # decode-batch size is a memory knob, not semantics (the reference's 64
    # targets GPU VRAM, automatic_mask_generator.py:46). Round-2 measured
    # 128 at +17% e2e, but after the round-4/5 kernel fusions the smaller
    # chunk wins again: PPB=64 vs 128 measured decode 508 vs 526 ms/img and
    # half+stats 119 vs 148 ms/img on the multicrop probe (the [192, C^2]
    # pass-1 transients double-buffer better than [384, C^2])
    points_per_batch=64,
    pred_iou_thresh=0.86,
    stability_score_thresh=0.92,
    crop_n_layers=1,
    crop_n_points_downscale_factor=2,
    min_mask_region_area=100,
    max_proposals=128,
)


# ---------------------------------------------------------------------------
# GEM (dense relevance)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GemConfig:
    """GEM self-self attention configuration.

    The reference consumes the external pip package ``gem-torch==1.0.1``
    (reference: Hybridgl_main.py:36-39). We reimplement the mechanism
    (qq/kk/vv self-self attention ensemble over the last ``depth`` ViT
    blocks, training-free) natively on our CLIP ViT.
    """

    img_size: int = 448
    depth: int = 7  # number of trailing blocks run with self-self attention
    ss_attn_iters: int = 1
    ss_attn_temp: Optional[float] = None  # None -> 1/sqrt(head_dim)


# ---------------------------------------------------------------------------
# Spatial guidance + selection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GuidanceConfig:
    """Hybrid-scoring + guidance constants.

    Reference values: r/alpha/k1/k2 (reference: Hybridgl_main.py:57-63),
    masking_block (:128), GEM fg/bg weights `black` (:211-216).
    """

    r: float = 0.5  # sentence/noun-phrase text ensemble weight
    alpha: float = 0.6  # relation vs GEM blend
    k1: int = 3
    k2: int = 6
    masking_block: int = 9
    black_big: float = 1.95
    black_small: float = 1.5
    black_other: float = 1.8
    max_other_nouns: int = 8  # static bucket for 'a photo of <noun>' negatives


# ---------------------------------------------------------------------------
# Behaviour-compat quirks
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompatConfig:
    """Reference behavioural quirks, reproducible on demand for parity.

    * ``k_clamp_sticky``: the reference clamps k1/k2 to the proposal count
      and never restores them, so one proposal-poor image permanently
      shrinks k1/k2 for the rest of the run
      (reference: Hybridgl_main.py:178-181).
    * ``rela_right_bug``: ``extract_rela_word`` compares ``token.text ==
      RIGHT_KEYWORDS`` (a set), so the "right" relation never fires
      (reference: utils.py:219).
    * ``attn_masking_early_exit``: fusion mode 'attn_masking' returns after
      block ``last_layer`` (10), one block earlier than every other mode
      (reference: model/backbone.py:197).
    """

    k_clamp_sticky: bool = True
    rela_right_bug: bool = True
    attn_masking_early_exit: bool = True


# ---------------------------------------------------------------------------
# Top-level pipeline config
# ---------------------------------------------------------------------------

FUSION_MODES = ("crop", "token_masking", "attn_masking", "L2G", "G2L", "G2L&L2G")


@dataclass(frozen=True)
class PipelineConfig:
    """One object that fully describes an eval run."""

    clip_model: str = "ViT-B/16"
    sam_model: str = "vit_h"
    # explicit config overrides (presets used when None); handy for tests
    clip_config: Optional[ClipConfig] = None
    sam_config: Optional[SamConfig] = None
    fusion_mode: str = "G2L"
    # canonical padded eval frame (COCO train2014 images are <= 640px)
    canonical_size: int = 640
    crop_size: int = 224  # reference Height,Width (Hybridgl_main.py:19)
    blur_ksize: int = 15  # reference cv2.GaussianBlur ksize (Hybridgl_main.py:99)
    amg: AmgConfig = AMG_REFCOCO
    gem: GemConfig = GemConfig()
    guidance: GuidanceConfig = GuidanceConfig()
    compat: CompatConfig = CompatConfig()
    # numerics
    compute_dtype: str = "bfloat16"  # matmul/activation dtype on TPU

    def __post_init__(self):
        if self.fusion_mode not in FUSION_MODES:
            raise ValueError(
                f"fusion_mode {self.fusion_mode!r} not in {FUSION_MODES}"
            )

    @property
    def clip(self) -> ClipConfig:
        return self.clip_config or clip_preset(self.clip_model)

    @property
    def sam(self) -> SamConfig:
        return self.sam_config or sam_preset(self.sam_model)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def tiny_smoke_config(
    fusion_mode: str = "G2L", min_mask_region_area: int = 0
) -> PipelineConfig:
    """Miniature pipeline (test-tiny models, 64px frames) for CI / CPU
    smoke runs of the full evaluation path."""
    return PipelineConfig(
        clip_model="test-tiny",
        sam_model="test-tiny",
        fusion_mode=fusion_mode,
        canonical_size=64,
        crop_size=clip_preset("test-tiny").image_size,
        amg=AmgConfig(
            points_per_side=4,
            points_per_batch=8,
            pred_iou_thresh=0.0,
            stability_score_thresh=0.0,
            min_mask_region_area=min_mask_region_area,
            max_proposals=8,
        ),
        gem=GemConfig(img_size=64, depth=2),
        guidance=GuidanceConfig(masking_block=1),
    )
