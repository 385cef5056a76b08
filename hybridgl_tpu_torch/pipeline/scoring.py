"""The feature and sentence stages of one image (port of the reference's
``feature_stage`` and ``sentence_stage_accum``, hybridgl_tpu/pipeline/runner.py:228-359).

As in the reference, the stages read nothing back: the image's (h, w), the
sentences' flags and counts, the clamped ``k1``/``k2``, the ground truth and
the accumulators are device tensors, the selected indices stay int64
tensors, and each picked proposal's (I, U, IoU) is added to the accumulators
on the device. So one captured CUDA graph a shape key serves every image
(``pipeline/score_graph.py``), and off the card the same functions run
eagerly. The host parses and tokenizes the sentences into :func:`sentence_arrays`,
padded to a power of two with row 0 repeated (the reference's
``_sentences_batched``, :760-770); a padded sentence's enable flag is 0, so
it adds nothing. The sequential runner and the data-parallel step
(``parallel/full_eval.py``) run these functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..eval.metrics import accumulate_sentences
from ..kernels.masks import box_xyxy_to_xywh
from ..kernels.resize import place_valid_region_antialias, resize_bilinear, valid_mask
from ..models.clip.fusion import calculate_score, hybrid_forward
from ..models.clip.text import encode_text
from ..models.gem.gem import gem_image_features, gem_preprocess
from ..utils.buckets import next_pow2
from ..utils.profiling import device_span
from ..utils.transfer import upload
from .guidance import gem_mask_scores, normalize_heatmap, select_candidates
from .preprocess import build_crops


class Ingredients(NamedTuple):
    """What the selection of one image's sentences needs (the reference's
    ``parallel/full_eval.py:Ingredients``): score tables over S sentences and P
    proposal slots, and each proposal's (I, U, IoU) against the ground truth.
    The runner selects from them on the device; the data-parallel step
    ships them, stacked over a batch of images as numpy arrays (a leading axis
    B on every field), to the rank that replays the sticky clamp."""

    num: object  # live proposals (after the cleanup), where the caller knows them
    score: torch.Tensor  # [S, P] f32 CLIP scores
    score_neg: torch.Tensor  # [S, P]
    gem_scores: torch.Tensor  # [S, P]
    boxes_xywh: torch.Tensor  # [P, 4]
    prop_valid: torch.Tensor  # [P] bool
    iu: torch.Tensor  # [P, 3] f32: (I, U, IoU) of each proposal against the ground truth


class SentenceInputs(NamedTuple):
    """An image's sentences on the device, the leading axis padded to S_b."""

    tokens: torch.Tensor  # [S_b, 2 + K, L] int32: sentence, noun phrase, other nouns
    ints: torch.Tensor  # [S_b, 4] int64: other nouns, direction flag, relation flag, has other nouns
    floats: torch.Tensor  # [S_b, 2] f32: black, enable (1 for a real sentence of an image with a ground truth)
    k: torch.Tensor  # [2] int64: the clamped k1, k2


class SentenceOutputs(NamedTuple):
    score: torch.Tensor  # [S_b, P] f32 hybrid CLIP scores
    picks: torch.Tensor  # [S_b, 2] int64: pure and final index
    iou: torch.Tensor  # [S_b, 2] f32: their IoUs
    acc: torch.Tensor  # [2, 4] f32: the pure and final accumulators with the real sentences added


def bucket_size(valid: np.ndarray, num: int) -> int:
    """The smallest power-of-two bucket (min 8, at most all slots) covering
    the highest live index of the host validity [P]: the cleanup invalidates
    suppressed duplicates in place, so validity is not always a prefix."""
    valid = np.asarray(valid)
    live = np.nonzero(valid)[0]
    extent = int(live[-1]) + 1 if live.size else num
    return min(next_pow2(extent, base=8), int(valid.shape[0]))


def sentence_arrays(rows, has_gt: bool):
    """``HybridGLPipeline._row`` tuples as host arrays padded to a power of
    two with row 0 repeated: (tokens [S_b, 2 + K, L] int32, ints [S_b, 4]
    int64, floats [S_b, 2] f32), the fields of :class:`SentenceInputs`."""
    n = len(rows)
    rows = list(rows) + [rows[0]] * (next_pow2(n) - n)
    tokens = np.stack([r[0] for r in rows]).astype(np.int32)
    ints = np.array([(r[1], r[2], r[3], int(r[5])) for r in rows], np.int64)
    enable = (np.arange(len(rows)) < n) & has_gt
    floats = np.stack([np.array([r[4] for r in rows], np.float32), enable.astype(np.float32)], axis=1)
    return tokens, ints, floats


def sentence_inputs(arrays, k, device) -> SentenceInputs:
    """:func:`sentence_arrays`' arrays and the clamped (k1, k2) on ``device``."""
    return SentenceInputs(*(upload(a, device) for a in arrays), upload(np.asarray(k, np.int64), device))


def fusion_features(cfg: PipelineConfig, clip_params, masks: torch.Tensor, image_c: torch.Tensor, hw, mp=None):
    """Crops -> hybrid fusion features [P, E]; ``hw`` the image's (h, w),
    numbers or device scalars. With ``mp`` (``parallel/mesh.py:ProcessMesh.mp_shard``:
    ``index``, ``size``, ``all_gather``) each member of a model-parallel
    group runs the fusion on its P / size proposals and the group gathers
    the features."""
    if mp is not None:
        if masks.shape[0] % mp.size:
            raise ValueError(f"{masks.shape[0]} proposal slots do not split over {mp.size} model-parallel ranks")
        shard = masks.shape[0] // mp.size
        masks = masks[mp.index * shard : (mp.index + 1) * shard]
    hw = (hw[0], hw[1])
    glob, local = build_crops(image_c, masks, hw, cfg.crop_size, cfg.blur_ksize)
    feats = hybrid_forward(
        clip_params["visual"], local, glob, masks.float(), cfg.clip,
        fusion_mode=cfg.fusion_mode, masking_block=cfg.guidance.masking_block,
        compat=cfg.compat, masks_hw=hw,
    )
    return feats if mp is None else mp.all_gather(feats)


def feature_stage(cfg: PipelineConfig, clip_params, masks: torch.Tensor, image_c: torch.Tensor, hw, mp=None):
    """Fusion features [P, E] (:func:`fusion_features`) and the normalised
    GEM patch features of one image, from its bucket's masks and canonical
    frame (reference runner.py:228-262)."""
    feats = fusion_features(cfg, clip_params, masks, image_c, hw, mp)
    # squash-resize the valid region to the GEM input (uint8 rounding as
    # the reference's PIL intermediate), then normalize
    gem_u8 = torch.round(
        resize_bilinear(image_c, (cfg.gem.img_size, cfg.gem.img_size), src_hw=(hw[0], hw[1]))
    ).to(torch.uint8)
    gem_img = gem_preprocess(gem_u8, cfg.gem.img_size)
    # GEM patch features are text-independent: once per image
    with device_span("gem"):
        gem_pf, _, _ = gem_image_features(clip_params["visual"], gem_img[None], cfg.clip, cfg.gem)
    gem_pf = gem_pf[0] / torch.clamp(torch.linalg.norm(gem_pf[0], dim=-1, keepdim=True), min=1e-6)
    return feats, gem_pf


def sentence_ingredients(cfg: PipelineConfig, clip_params, props, feats, gem_pf, sent: SentenceInputs, hw,
                         gt) -> Ingredients:
    """The score tables of all of an image's sentences at once, a leading
    sentence dimension: the text encoder, both scores, the heatmap's resize,
    placement and normalisation and the per-mask GEM scores are batched.
    ``props`` has the bucket's ``masks``, ``boxes_xyxy``, ``valid`` (and
    ``num``, passed through); ``gt`` the [C, C] bool ground truth. A
    sentence's scores do not depend on the sentences beside it."""
    C = cfg.canonical_size
    dev = feats.device
    toks = sent.tokens
    S = toks.shape[0]
    n_others, dir_flag = sent.ints[:, 0], sent.ints[:, 1]
    tf = encode_text(clip_params["text"], toks.reshape(-1, toks.shape[-1]), cfg.clip)
    tf = tf.reshape(S, toks.shape[1], -1)
    sent_f, np_f, other_f = tf[:, 0], tf[:, 1], tf[:, 2:]
    r = cfg.guidance.r
    ls = clip_params["logit_scale"]
    score = calculate_score(feats, r * sent_f + (1 - r) * np_f, ls).T  # [S, P]
    k_mask = torch.arange(other_f.shape[1], device=dev)[None, :] < n_others[:, None]
    neg_sum = torch.where(k_mask[..., None], other_f, 0.0).sum(1)
    neg_mean = torch.where((n_others > 0)[:, None], neg_sum / torch.clamp(n_others, min=1)[:, None], 0.0)
    neg_norm = torch.clamp(torch.linalg.norm(neg_mean, dim=-1, keepdim=True), min=1e-6)
    score_neg = (torch.exp(ls) * (feats / torch.linalg.norm(feats, dim=-1, keepdim=True)) @ (neg_mean / neg_norm).T).T

    g = cfg.gem.img_size // cfg.clip.patch_size
    npf_n = np_f / torch.clamp(torch.linalg.norm(np_f, dim=-1, keepdim=True), min=1e-6)
    rel = (gem_pf @ npf_n.T).reshape(g, g, S)  # the sentence axis rides as the channel axis
    heat448 = resize_bilinear(rel, (cfg.gem.img_size, cfg.gem.img_size))
    hw = (hw[0], hw[1])
    heat = place_valid_region_antialias(heat448, (C, C), hw).movedim(-1, 0)  # [S, C, C]
    vm = valid_mask((C, C), hw, dev)
    heat = normalize_heatmap(heat, vm, dir_flag, hw)
    gem_scores = gem_mask_scores(heat, props.masks, vm, sent.floats[:, 0])  # [S, P]
    # every proposal's (I, U, IoU) against the ground truth (mask_iou, for all P at once)
    i = (props.masks & gt).sum(dim=(-2, -1)).float()
    u = (props.masks | gt).sum(dim=(-2, -1)).float()
    iou = torch.where(u == 0, 0.0, i / torch.clamp(u, min=1.0))
    return Ingredients(props.num, score, score_neg, gem_scores, box_xyxy_to_xywh(props.boxes_xyxy), props.valid,
                       torch.stack([i, u, iou], dim=-1))


def select_sentences(cfg: PipelineConfig, ing: Ingredients, sent: SentenceInputs):
    """``select_candidates`` of every sentence at once, on the device: a
    ``guidance.Selection`` with a leading sentence axis."""
    return select_candidates(ing.score, ing.score_neg, ing.boxes_xywh, ing.gem_scores, ing.prop_valid,
                             sent.ints[:, 2], sent.ints[:, 3] != 0, sent.k[0], sent.k[1], alpha=cfg.guidance.alpha)


def sentence_stage(cfg: PipelineConfig, clip_params, props, feats, gem_pf, sent: SentenceInputs, hw, gt,
                   acc: torch.Tensor) -> SentenceOutputs:
    """The sentence stage with the accumulators riding along (the
    reference's ``sentence_stage_accum``, runner.py:320-344, batched over
    sentences): the score tables, the selections, each pick's IoU, and
    ``acc`` [2, 4] (pure, final) with each enabled sentence added in order."""
    ing = sentence_ingredients(cfg, clip_params, props, feats, gem_pf, sent, hw, gt)
    sel = select_sentences(cfg, ing, sent)
    pure_iu, final_iu = ing.iu[sel.pure_index], ing.iu[sel.final_index]
    acc = accumulate_sentences(acc, pure_iu, final_iu, sent.floats[:, 1])
    return SentenceOutputs(ing.score, torch.stack([sel.pure_index, sel.final_index], dim=-1),
                           torch.stack([pure_iu[:, 2], final_iu[:, 2]], dim=-1), acc)
