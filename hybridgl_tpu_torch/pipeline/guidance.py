"""Spatial guidance + candidate selection on the device (port of hybridgl_tpu/pipeline/guidance.py).

Box-relation scoring over the top-k1 x top-k2 candidates, the directional
position prior, GEM heatmap normalisation and per-mask foreground/background
scoring, and selection (reference: Hybridgl_main.py:168-228, utils.py:135-161,
240-268). As in the reference, nothing here reads the device: the flags are
the reference's small integer enums held in tensors (the relation scores and
the position priors are computed for every flag and the sentence's own is
gathered), ``k1``/``k2`` and the image's width are device scalars, and the
selected indices stay int64 tensors. So one captured CUDA graph serves every
sentence and image. Every function takes a leading batch of sentences.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.transfer import upload

RELA_FLAGS = ("none", "left", "right", "up", "down", "big", "small", "within")
DIR_FLAGS = ("none", "left", "right", "middle", "up", "down")

K1_MAX = 3  # reference k1 (Hybridgl_main.py:62)
K2_MAX = 6  # reference k2 (Hybridgl_main.py:63)

NEG = -1e30


def rela_flag_id(name: str) -> int:
    return RELA_FLAGS.index(name)


def dir_flag_id(name: str) -> int:
    return DIR_FLAGS.index(name)


def relation_scores(boxes_i, boxes_j, scores_i, scores_j, rela_flag, pair_valid):
    """Vectorised ``relation_boxes`` summed over j -> [..., K1] (utils.py:240-268):
    boxes [..., K, 4] xywh, scores [..., K], ``rela_flag`` [...] (an index
    into RELA_FLAGS), pair_valid [..., K1, K2]. All eight predicates are
    computed and each row's own is gathered (reference guidance.py:48-99)."""
    cx_i = boxes_i[..., 0] + boxes_i[..., 2] / 2
    cx_j = boxes_j[..., 0] + boxes_j[..., 2] / 2
    cy_i = boxes_i[..., 1] + boxes_i[..., 3] / 2
    cy_j = boxes_j[..., 1] + boxes_j[..., 3] / 2
    area_i = boxes_i[..., 2] * boxes_i[..., 3]
    area_j = boxes_j[..., 2] * boxes_j[..., 3]
    si_sj = scores_i[..., :, None] * scores_j[..., None, :]
    left = si_sj * (cx_i[..., :, None] < cx_j[..., None, :])
    right = si_sj * (cx_i[..., :, None] > cx_j[..., None, :])
    up = si_sj * (cy_i[..., :, None] < cy_j[..., None, :])
    down = si_sj * (cy_i[..., :, None] > cy_j[..., None, :])
    big = si_sj * (area_i[..., :, None] > area_j[..., None, :])
    small = si_sj * (area_i[..., :, None] < area_j[..., None, :])
    # within: clamped overlap box area over area_i (utils.py:259-264)
    bi, bj = boxes_i[..., :, None, :], boxes_j[..., None, :, :]
    x1 = torch.maximum(bi[..., 0], bj[..., 0])
    x2 = torch.maximum(x1, torch.minimum(bi[..., 0] + bi[..., 2], bj[..., 0] + bj[..., 2]))
    y1 = torch.maximum(bi[..., 1], bj[..., 1])
    y2 = torch.maximum(y1, torch.minimum(bi[..., 1] + bi[..., 3], bj[..., 1] + bj[..., 3]))
    within = si_sj * (x2 - x1) * (y2 - y1) / area_i[..., :, None]
    none = scores_i[..., :, None].expand_as(si_sj)
    table = torch.stack([none, left, right, up, down, big, small, within])  # [8, ..., K1, K2]
    flag = upload(rela_flag, si_sj.device, torch.long)
    per_pair = table.gather(0, flag.reshape(1, *flag.shape, 1, 1).expand(1, *si_sj.shape))[0]
    return torch.where(pair_valid, per_pair, 0.0).sum(dim=-1)


def dir_priors(frame: int, width, device="cpu") -> torch.Tensor:
    """The six position priors as rows over the frame's columns [6, frame]
    (utils.py:135-161; each prior is constant down a column): ``width`` a
    number or a device scalar. 'up' and 'down' are ones, as in the reference,
    whose branches for them are commented out (utils.py:147-155)."""
    w = upload(width, device, torch.float32)
    j = torch.arange(frame, dtype=torch.float32, device=device)
    left = 1.0 - j / torch.clamp(w - 1.0, min=1.0)
    right = j / torch.clamp(w - 1.0, min=1.0)
    m1 = torch.floor(w / 2.0)
    m2 = w - m1
    middle = torch.where(j < m1, j / torch.clamp(m1 - 1.0, min=1.0), 1.0 - (j - m1) / torch.clamp(m2 - 1.0, min=1.0))
    ones = torch.ones_like(j)
    return torch.stack([ones, left, right, middle, ones, ones])


def dir_mask(dir_flag, frame: int, hw, device="cpu") -> torch.Tensor:
    """[frame, frame] position prior of one flag over the valid (h, w) region."""
    row = dir_priors(frame, hw[1], device).index_select(0, upload(dir_flag, device, torch.long).reshape(1))
    return row.expand(frame, frame)


def region_hw(valid_region: torch.Tensor):
    """The valid region's (h, w) as device scalars (reference ``_region_hw``)."""
    return valid_region.any(dim=1).sum(), valid_region.any(dim=0).sum()


def normalize_heatmap(imgattn: torch.Tensor, valid_region: torch.Tensor, dir_flag, hw=None) -> torch.Tensor:
    """min-max normalise -> directional prior -> mean-normalise over the valid
    region (Hybridgl_main.py:204-209). One heatmap [C, C] with its flag, or a
    batch [S, C, C] with S flags (a tensor [S] or a sequence). ``hw`` is the
    valid region's (h, w) (numbers or device scalars), computed from the
    region on the device when not given."""
    batched = imgattn.ndim == 3
    x = imgattn if batched else imgattn[None]
    flags = upload(dir_flag, x.device, torch.long).reshape(-1)
    lo = torch.where(valid_region, x, torch.inf).amin(dim=(-2, -1), keepdim=True)
    hi = torch.where(valid_region, x, -torch.inf).amax(dim=(-2, -1), keepdim=True)
    x = (x - lo) / (hi - lo)
    x = torch.where(valid_region, x, 0.0)
    width = (region_hw(valid_region) if hw is None else hw)[1]
    x = x * dir_priors(x.shape[-1], width, x.device).index_select(0, flags)[:, None, :]
    mean = x.sum(dim=(-2, -1), keepdim=True) / valid_region.sum()
    out = torch.where(valid_region, x / mean, 0.0)
    return out if batched else out[0]


def gem_mask_scores(imgattn, masks, valid_region, black) -> torch.Tensor:
    """mean_in_mask(attn) * (2 - black) - mean_out_of_mask(attn) * black
    (Hybridgl_main.py:218-222) -> [P]; for a batch of heatmaps [S, C, C] with
    ``black`` a tensor [S] -> [S, P]."""
    P = masks.shape[0]
    m2 = (masks & valid_region[None]).float().reshape(P, -1)
    inv2 = (~masks & valid_region[None]).float().reshape(P, -1)
    if imgattn.ndim == 3:
        flat = imgattn.reshape(imgattn.shape[0], -1).T  # [C * C, S]
        in_mean = ((m2 @ flat) / torch.clamp(m2.sum(-1), min=1.0)[:, None]).T
        out_mean = ((inv2 @ flat) / torch.clamp(inv2.sum(-1), min=1.0)[:, None]).T
        black = black[:, None]
        return (2.0 - black) * in_mean - black * out_mean
    flat = imgattn.reshape(-1)
    in_mean = (m2 @ flat) / torch.clamp(m2.sum(-1), min=1.0)
    out_mean = (inv2 @ flat) / torch.clamp(inv2.sum(-1), min=1.0)
    return (2.0 - black) * in_mean - black * out_mean


class Selection(NamedTuple):
    pure_index: torch.Tensor  # [...] int64: argmax of the hybrid CLIP score
    final_index: torch.Tensor  # [...] int64: after spatial guidance
    topk_indices: torch.Tensor  # [..., K1_MAX]
    topscores: torch.Tensor  # [..., K1_MAX] blended guidance scores


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, ties to the lower index (lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def select_candidates(score_clip, score_clip_neg, boxes_xywh, gem_scores, proposal_valid, rela_flag, has_other_nouns,
                      k1, k2, alpha: float = 0.6) -> Selection:
    """Candidate selection (Hybridgl_main.py:168-228) of a batch of sentences:
    scores [..., P] over the shared boxes [P, 4] and validity [P]; the flags
    [...] (tensors, or numbers for one sentence) and ``k1``/``k2`` (device
    scalars or numbers) select on the device. Both relation branches are
    computed and ``has_other_nouns`` picks one (reference :239)."""
    P = score_clip.shape[-1]
    dev = score_clip.device
    masked = torch.where(proposal_valid, score_clip, NEG)
    masked_neg = torch.where(proposal_valid, score_clip_neg, NEG)
    pure_index = torch.argmax(masked, dim=-1)
    sm = torch.softmax(masked, dim=-1)
    sm_neg = torch.softmax(masked_neg, dim=-1)
    k1_max, k2_max = min(K1_MAX, P), min(K2_MAX, P)
    maxidxs = _top_k(masked, k1_max)
    maxneg = _top_k(masked_neg, k2_max)
    i_valid = torch.arange(k1_max, device=dev) < upload(k1, dev, torch.long)
    j2_valid = torch.arange(k2_max, device=dev) < upload(k2, dev, torch.long)
    bi = boxes_xywh[maxidxs]
    si = sm.gather(-1, maxidxs)
    # no other nouns: pairs among the top-k1, sm scores; other nouns: pairs against the top-k2 negatives
    rel_a = relation_scores(bi, bi, si, si, rela_flag, i_valid[:, None] & i_valid[None, :])
    rel_b = relation_scores(bi, boxes_xywh[maxneg], si, sm_neg.gather(-1, maxneg), rela_flag,
                            i_valid[:, None] & j2_valid[None, :])
    topscores = torch.where(upload(has_other_nouns, dev, torch.bool)[..., None], rel_b, rel_a)
    topscores = torch.softmax(torch.where(i_valid, topscores, NEG), dim=-1)
    blended = topscores * (1.0 - alpha) + alpha * gem_scores.gather(-1, maxidxs)
    blended = torch.where(i_valid, blended, NEG)
    final_index = maxidxs.gather(-1, torch.argmax(blended, dim=-1, keepdim=True))[..., 0]
    return Selection(pure_index, final_index, maxidxs, blended)
