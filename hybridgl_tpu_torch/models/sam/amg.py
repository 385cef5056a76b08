"""Single-crop automatic mask generation (port of hybridgl_tpu/models/sam/amg.py:120-266).

The reference's two-pass design, on the card:
  * pass 1 decodes every grid point in ``points_per_batch`` chunks and keeps
    only per-candidate scalars: the column half-transform is a plain matmul
    and the row transform, thresholds and profiles run in K5
    (``pass1_stats_half``), so the [B*3, C, C] canonical frame is never
    stored;
  * filtering (predicted IoU, stability, crop edge, non-empty) is validity
    masking; NMS keeps candidates in score order;
  * pass 2 gathers the survivors' 256^2 logits from the pass-1 cache (or
    re-decodes them when the cache would be too large) and places them into
    the canonical frame with the composed two-stage resize.

Masks live in the canonical eval frame: a [C, C] zero-padded buffer whose
top-left (h, w) corner is the image at original resolution.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hybridgl_tpu.core.config import AmgConfig, SamConfig

from ...kernels.masks import box_from_profiles, box_near_crop_edge
from ...kernels.nms import kept_in_score_order, nms
from ...kernels.pass1_stats import half_transform, pass1_stats_half
from ...kernels.resize import _composed_axis_weights, place_two_stage
from .prompt_encoder import dense_pe, no_mask_dense
from .sam import encode, predict_points, preprocess_padded

PAD_NEG = -1e4  # logit fill outside the valid image region
M = 3  # multimask outputs per point


class Proposals(NamedTuple):
    """Proposal bundle in the canonical eval frame (reference amg.py:64)."""

    masks: torch.Tensor  # [P, C, C] bool
    boxes_xyxy: torch.Tensor  # [P, 4] f32, original-resolution coords
    iou_preds: torch.Tensor  # [P] f32
    stability: torch.Tensor  # [P] f32
    points: torch.Tensor  # [P, 2] f32, original-resolution coords
    areas: torch.Tensor  # [P] f32 (mask pixel count)
    valid: torch.Tensor  # [P] bool
    num: int
    # NMS survivors dropped by the max_proposals bucket (the reference keeps
    # every survivor, so a nonzero value is coverage loss)
    overflow: int = 0


def build_point_grid(n_per_side: int) -> np.ndarray:
    """Evenly spaced [0,1]^2 grid (reference utils/amg.py:179-186)."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    px = np.tile(side[None, :], (n_per_side, 1))
    py = np.tile(side[:, None], (1, n_per_side))
    return np.stack([px, py], axis=-1).reshape(-1, 2).astype(np.float32)


def _chunk_points(grid01: np.ndarray, chunk: int) -> np.ndarray:
    pad = (-grid01.shape[0]) % chunk
    if pad:
        grid01 = np.concatenate([grid01, np.zeros((pad, 2), np.float32)], axis=0)
    return grid01.reshape(-1, chunk, 2)


def _canonical_logits(low_res, rh, rw, h, w, sam_cfg: SamConfig, canonical: int):
    """[B, 256, 256] low-res logits -> [B, C, C] canonical-frame logits (two-
    stage bilinear of the reference postprocess, sam.py:154-161; PAD_NEG fill)."""
    return place_two_stage(low_res, sam_cfg.img_size, (rh, rw), (canonical, canonical), (0, 0), (h, w), fill=PAD_NEG)


def generate_proposals(p_sam, image_1024, rh, rw, h, w, sam_cfg: SamConfig, amg_cfg: AmgConfig, canonical: int = 640, embedding=None) -> Proposals:
    """Single-crop AMG (crop_n_layers = 0, the RefCOCO configuration).

    image_1024: [S, S, 3] padded frame on the target device; (rh, rw) its
    valid extent, (h, w) the original image size (<= canonical)."""
    dev = image_1024.device
    x = preprocess_padded(image_1024, (rh, rw), sam_cfg)
    if embedding is None:
        embedding = encode(p_sam, x, sam_cfg)

    grid01 = build_point_grid(amg_cfg.points_per_side)
    n_points = grid01.shape[0]
    chunks = torch.from_numpy(_chunk_points(grid01, amg_cfg.points_per_batch)).to(dev)
    B = amg_cfg.points_per_batch
    n_cand = chunks.shape[0] * B * M
    # keep pass 1's 256^2 logits for pass 2 when they fit (single crop at
    # RefCOCO: 192 x 256^2 f32 = 50 MB) instead of re-decoding the survivors
    cache_low_res = n_cand * 256 * 256 * 4 <= 256 * 1024 * 1024

    scale_1024 = torch.tensor([float(rw), float(rh)], device=dev)
    orig_scale = torch.tensor([float(w), float(h)], device=dev)
    n_low = sam_cfg.embed_grid * 4
    Wy = _composed_axis_weights(canonical, n_low, sam_cfg.img_size, rh, 0, h, dev)
    Wx = _composed_axis_weights(canonical, n_low, sam_cfg.img_size, rw, 0, w, dev)
    pe = dense_pe(p_sam["prompt"], sam_cfg)
    dense = no_mask_dense(p_sam["prompt"], sam_cfg, 1)[0]
    img_box = torch.tensor([0.0, 0.0, float(w), float(h)], device=dev)

    ious, stabs, boxes, valids, lows = [], [], [], [], []
    for pts01 in chunks:
        coords = (pts01 * scale_1024)[:, None, :]
        labels = torch.ones((B, 1), device=dev)
        low, iou_preds = predict_points(p_sam, embedding, coords, labels, sam_cfg, True, pe=pe, dense=dense)
        flat = low.reshape(B * M, n_low, n_low)
        half = half_transform(flat, Wx.T)
        stab, row_any, col_any = pass1_stats_half(
            half, Wy, (0, 0, h, w), sam_cfg.mask_threshold, amg_cfg.stability_score_offset
        )
        bx = box_from_profiles(row_any, col_any)
        valid = torch.ones((B * M,), dtype=torch.bool, device=dev)
        if amg_cfg.pred_iou_thresh > 0:
            valid &= iou_preds.reshape(-1) > amg_cfg.pred_iou_thresh
        if amg_cfg.stability_score_thresh > 0:
            valid &= stab >= amg_cfg.stability_score_thresh
        # identity for a single crop (crop box == image box), kept for parity
        valid &= ~box_near_crop_edge(bx, img_box, img_box)
        valid &= row_any.any(dim=-1)  # drop empty masks
        ious.append(iou_preds.reshape(-1))
        stabs.append(stab)
        boxes.append(bx)
        valids.append(valid)
        if cache_low_res:
            lows.append(flat)
    iou_all = torch.cat(ious)
    stab_all = torch.cat(stabs)
    boxes_all = torch.cat(boxes)
    point_idx = torch.arange(n_cand, device=dev) // M
    valid_all = torch.cat(valids) & (point_idx < n_points)

    # NMS over all candidates, scored by predicted IoU as the reference does
    res = nms(boxes_all, iou_all, amg_cfg.box_nms_thresh, valid_all)
    P = amg_cfg.max_proposals
    kept_idx, kept_valid = kept_in_score_order(res, P)

    kept_point = kept_idx // M
    kept_channel = kept_idx % M
    pts01 = chunks.reshape(-1, 2)[kept_point]
    if cache_low_res:
        sel = torch.cat(lows)[kept_idx]
    else:
        coords = (pts01 * scale_1024)[:, None, :]
        labels = torch.ones((P, 1), device=dev)
        low_res, _ = predict_points(p_sam, embedding, coords, labels, sam_cfg, True)
        sel = low_res[torch.arange(P, device=dev), kept_channel]
    logits = _canonical_logits(sel, rh, rw, h, w, sam_cfg, canonical)
    masks = (logits > sam_cfg.mask_threshold) & kept_valid[:, None, None]
    kv = kept_valid.float()
    return Proposals(
        masks=masks,
        boxes_xyxy=boxes_all[kept_idx] * kv[:, None],
        iou_preds=iou_all[kept_idx] * kv,
        stability=stab_all[kept_idx] * kv,
        points=(pts01 * orig_scale) * kv[:, None],
        areas=masks.sum(dim=(-2, -1)).float(),
        valid=kept_valid,
        num=min(max(res.num_kept, 0), P),
        overflow=max(res.num_kept - P, 0),
    )
