"""Spatial guidance + candidate selection (port of hybridgl_tpu/pipeline/guidance.py).

Box-relation scoring over the top-k1 x top-k2 candidates, the directional
position prior, GEM heatmap normalisation and per-mask foreground/background
scoring, and selection (reference: Hybridgl_main.py:168-228, utils.py:135-161,
240-268). Flags are the reference's small integer enums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

RELA_FLAGS = ("none", "left", "right", "up", "down", "big", "small", "within")
DIR_FLAGS = ("none", "left", "right", "middle", "up", "down")

K1_MAX = 3  # reference k1 (Hybridgl_main.py:62)
K2_MAX = 6  # reference k2 (Hybridgl_main.py:63)

NEG = -1e30


def rela_flag_id(name: str) -> int:
    return RELA_FLAGS.index(name)


def dir_flag_id(name: str) -> int:
    return DIR_FLAGS.index(name)


def relation_scores(boxes_i, boxes_j, scores_i, scores_j, rela_flag: int, pair_valid):
    """Vectorised ``relation_boxes`` summed over j -> [K1] (utils.py:240-268)."""
    cx_i = boxes_i[:, 0] + boxes_i[:, 2] / 2
    cx_j = boxes_j[:, 0] + boxes_j[:, 2] / 2
    cy_i = boxes_i[:, 1] + boxes_i[:, 3] / 2
    cy_j = boxes_j[:, 1] + boxes_j[:, 3] / 2
    area_i = boxes_i[:, 2] * boxes_i[:, 3]
    area_j = boxes_j[:, 2] * boxes_j[:, 3]
    si_sj = scores_i[:, None] * scores_j[None, :]
    flag = RELA_FLAGS[rela_flag]
    if flag == "none":
        per_pair = scores_i[:, None].expand_as(si_sj)
    elif flag == "left":
        per_pair = si_sj * (cx_i[:, None] < cx_j[None, :])
    elif flag == "right":
        per_pair = si_sj * (cx_i[:, None] > cx_j[None, :])
    elif flag == "up":
        per_pair = si_sj * (cy_i[:, None] < cy_j[None, :])
    elif flag == "down":
        per_pair = si_sj * (cy_i[:, None] > cy_j[None, :])
    elif flag == "big":
        per_pair = si_sj * (area_i[:, None] > area_j[None, :])
    elif flag == "small":
        per_pair = si_sj * (area_i[:, None] < area_j[None, :])
    else:  # within: clamped overlap box area over area_i (utils.py:259-264)
        x1 = torch.maximum(boxes_i[:, None, 0], boxes_j[None, :, 0])
        x2 = torch.maximum(
            x1,
            torch.minimum(boxes_i[:, None, 0] + boxes_i[:, None, 2], boxes_j[None, :, 0] + boxes_j[None, :, 2]),
        )
        y1 = torch.maximum(boxes_i[:, None, 1], boxes_j[None, :, 1])
        y2 = torch.maximum(
            y1,
            torch.minimum(boxes_i[:, None, 1] + boxes_i[:, None, 3], boxes_j[None, :, 1] + boxes_j[None, :, 3]),
        )
        per_pair = si_sj * (x2 - x1) * (y2 - y1) / area_i[:, None]
    return torch.where(pair_valid, per_pair, 0.0).sum(dim=1)


def dir_mask(dir_flag: int, frame: int, hw, device="cpu") -> torch.Tensor:
    """[frame, frame] position prior over the valid (h, w) region; 'up' and
    'down' are ones, as in the reference (utils.py:147-155)."""
    w = float(hw[1])
    j = torch.arange(frame, dtype=torch.float32, device=device)[None, :].expand(frame, frame)
    flag = DIR_FLAGS[dir_flag]
    if flag == "left":
        return 1.0 - j / max(w - 1.0, 1.0)
    if flag == "right":
        return j / max(w - 1.0, 1.0)
    if flag == "middle":
        m1 = float(w // 2)
        m2 = w - m1
        return torch.where(j < m1, j / max(m1 - 1.0, 1.0), 1.0 - (j - m1) / max(m2 - 1.0, 1.0))
    return torch.ones((frame, frame), dtype=torch.float32, device=device)


def normalize_heatmap(imgattn: torch.Tensor, valid_region: torch.Tensor, dir_flag) -> torch.Tensor:
    """min-max normalise -> directional prior -> mean-normalise over the valid
    region (Hybridgl_main.py:204-209). One heatmap [C, C] with its flag, or a
    batch [S, C, C] with a sequence of S flags."""
    batched = imgattn.ndim == 3
    x = imgattn if batched else imgattn[None]
    flags = list(dir_flag) if batched else [dir_flag]
    lo = torch.where(valid_region, x, torch.inf).amin(dim=(-2, -1), keepdim=True)
    hi = torch.where(valid_region, x, -torch.inf).amax(dim=(-2, -1), keepdim=True)
    x = (x - lo) / (hi - lo)
    x = torch.where(valid_region, x, 0.0)
    h = int(valid_region.any(dim=1).sum())
    w = int(valid_region.any(dim=0).sum())
    prior = {f: dir_mask(f, x.shape[-1], (h, w), x.device) for f in set(flags)}
    x = x * torch.stack([prior[f] for f in flags])
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
    pure_index: int  # argmax of the hybrid CLIP score
    final_index: int  # after spatial guidance
    topk_indices: torch.Tensor  # [K1_MAX]
    topscores: torch.Tensor  # [K1_MAX] blended guidance scores


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lower index (lax.top_k's order)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def select_candidates(score_clip, score_clip_neg, boxes_xywh, gem_scores, proposal_valid, rela_flag: int, has_other_nouns: bool, k1: int, k2: int, alpha: float = 0.6) -> Selection:
    """Per-sentence candidate selection (Hybridgl_main.py:168-228)."""
    P = score_clip.shape[0]
    dev = score_clip.device
    masked = torch.where(proposal_valid, score_clip, NEG)
    masked_neg = torch.where(proposal_valid, score_clip_neg, NEG)
    pure_index = int(torch.argmax(masked))
    sm = torch.softmax(masked, dim=0)
    sm_neg = torch.softmax(masked_neg, dim=0)
    k1_max, k2_max = min(K1_MAX, P), min(K2_MAX, P)
    maxidxs = _top_k(masked, k1_max)
    maxneg = _top_k(masked_neg, k2_max)
    i_valid = torch.arange(k1_max, device=dev) < k1
    j2_valid = torch.arange(k2_max, device=dev) < k2
    bi = boxes_xywh[maxidxs]
    si = sm[maxidxs]
    if has_other_nouns:  # pairs against the top-k2 negatives, sm_neg scores
        topscores = relation_scores(
            bi, boxes_xywh[maxneg], si, sm_neg[maxneg], rela_flag, i_valid[:, None] & j2_valid[None, :]
        )
    else:  # pairs among the top-k1, sm scores
        topscores = relation_scores(bi, bi, si, si, rela_flag, i_valid[:, None] & i_valid[None, :])
    topscores = torch.softmax(torch.where(i_valid, topscores, NEG), dim=0)
    blended = topscores * (1.0 - alpha) + alpha * gem_scores[maxidxs]
    blended = torch.where(i_valid, blended, NEG)
    final_index = int(maxidxs[torch.argmax(blended)])
    return Selection(pure_index, final_index, maxidxs, blended)
