"""Automatic mask generation (port of hybridgl_tpu/models/sam/amg.py).

Single crop (crop_n_layers = 0, RefCOCO, :120-266) and one crop layer
(crop_n_layers = 1, PhraseCut, :276-586). The reference's two-pass design,
on the card:
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

Multicrop adds four overlapping crops (five encoder passes), per-crop NMS
into ``max_candidates_per_crop`` buckets, a cross-crop NMS scored by
1/crop-area, and one batched pass-2 re-decode of all survivors in which each
candidate's crop embedding rides the dense-prompt slot (the decoder's
per-prompt route: K7 and K8).

Masks live in the canonical eval frame: a [C, C] zero-padded buffer whose
top-left (h, w) corner is the image at original resolution.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...core.config import AmgConfig, SamConfig

from ...kernels.masks import box_from_profiles, box_near_crop_edge
from ...kernels.nms import kept_in_score_order, nms
from ...kernels.pass1_stats import half_transform, pass1_stats_half
from ...kernels.resize import _composed_axis_weights, place_region, place_two_stage
from .decoder import predict_masks
from .prompt_encoder import dense_pe, embed_points, no_mask_dense
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


def _score_candidates(p_sam, embedding, grid01, origin, extent, rhw, img_hw, sam_cfg: SamConfig,
                      amg_cfg: AmgConfig, canonical: int, keep_low: bool = False):
    """Pass 1 over every (point, mask) candidate of one crop whose window in
    the canonical frame is ``origin`` (y0, x0) + ``extent`` (ch, cw) and whose
    valid extent in SAM's frame is ``rhw``. Returns (iou, stab, boxes, valid,
    pts01 [n_points_padded, 2], the 256^2 logits or None)."""
    dev = embedding.device
    chunks = torch.from_numpy(_chunk_points(grid01, amg_cfg.points_per_batch)).to(dev)
    B = amg_cfg.points_per_batch
    (y0, x0), (ch, cw), (rh, rw), (h, w) = origin, extent, rhw, img_hw
    scale_1024 = torch.tensor([float(rw), float(rh)], device=dev)
    n_low = sam_cfg.embed_grid * 4
    Wy = _composed_axis_weights(canonical, n_low, sam_cfg.img_size, rh, y0, ch, dev)
    Wx = _composed_axis_weights(canonical, n_low, sam_cfg.img_size, rw, x0, cw, dev)
    pe = dense_pe(p_sam["prompt"], sam_cfg)
    dense = no_mask_dense(p_sam["prompt"], sam_cfg, 1)[0]
    img_box = torch.tensor([0.0, 0.0, float(w), float(h)], device=dev)
    crop_box = torch.tensor([float(x0), float(y0), float(x0) + float(cw), float(y0) + float(ch)], device=dev)

    ious, stabs, boxes, valids, lows = [], [], [], [], []
    for pts01 in chunks:
        coords = (pts01 * scale_1024)[:, None, :]
        labels = torch.ones((B, 1), device=dev)
        low, iou_preds = predict_points(p_sam, embedding, coords, labels, sam_cfg, True, pe=pe, dense=dense)
        flat = low.reshape(B * M, n_low, n_low)
        half = half_transform(flat, Wx.T)
        stab, row_any, col_any = pass1_stats_half(
            half, Wy, (y0, x0, ch, cw), sam_cfg.mask_threshold, amg_cfg.stability_score_offset
        )
        bx = box_from_profiles(row_any, col_any)
        valid = torch.ones((B * M,), dtype=torch.bool, device=dev)
        if amg_cfg.pred_iou_thresh > 0:
            valid &= iou_preds.reshape(-1) > amg_cfg.pred_iou_thresh
        if amg_cfg.stability_score_thresh > 0:
            valid &= stab >= amg_cfg.stability_score_thresh
        # an identity for the full-image crop (crop box == image box)
        valid &= ~box_near_crop_edge(bx, crop_box, img_box)
        valid &= row_any.any(dim=-1)  # drop empty masks
        ious.append(iou_preds.reshape(-1))
        stabs.append(stab)
        boxes.append(bx)
        valids.append(valid)
        if keep_low:
            lows.append(flat)
    n_cand = chunks.shape[0] * B * M
    point_idx = torch.arange(n_cand, device=dev) // M
    valid_all = torch.cat(valids) & (point_idx < grid01.shape[0])  # padded grid points
    low_all = torch.cat(lows) if keep_low else None
    return torch.cat(ious), torch.cat(stabs), torch.cat(boxes), valid_all, chunks.reshape(-1, 2), low_all


def generate_proposals(p_sam, image_1024, rh, rw, h, w, sam_cfg: SamConfig, amg_cfg: AmgConfig, canonical: int = 640, embedding=None) -> Proposals:
    """Single-crop AMG (crop_n_layers = 0, the RefCOCO configuration).

    image_1024: [S, S, 3] padded frame on the target device; (rh, rw) its
    valid extent, (h, w) the original image size (<= canonical)."""
    dev = image_1024.device
    x = preprocess_padded(image_1024, (rh, rw), sam_cfg)
    if embedding is None:
        embedding = encode(p_sam, x, sam_cfg)

    grid01 = build_point_grid(amg_cfg.points_per_side)
    B = amg_cfg.points_per_batch
    n_cand = -(-grid01.shape[0] // B) * B * M
    # keep pass 1's 256^2 logits for pass 2 when they fit (single crop at
    # RefCOCO: 192 x 256^2 f32 = 50 MB) instead of re-decoding the survivors
    cache_low_res = n_cand * 256 * 256 * 4 <= 256 * 1024 * 1024
    iou_all, stab_all, boxes_all, valid_all, grid_pts, lows = _score_candidates(
        p_sam, embedding, grid01, (0, 0), (h, w), (rh, rw), (h, w), sam_cfg, amg_cfg, canonical, cache_low_res
    )

    # NMS over all candidates, scored by predicted IoU as the reference does
    res = nms(boxes_all, iou_all, amg_cfg.box_nms_thresh, valid_all)
    P = amg_cfg.max_proposals
    kept_idx, kept_valid = kept_in_score_order(res, P)

    kept_point = kept_idx // M
    kept_channel = kept_idx % M
    pts01 = grid_pts[kept_point]
    scale_1024 = torch.tensor([float(rw), float(rh)], device=dev)
    orig_scale = torch.tensor([float(w), float(h)], device=dev)
    if cache_low_res:
        sel = lows[kept_idx]
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


def _crop_boxes_layer1(h, w, overlap_ratio: float):
    """The four layer-1 crop boxes as (y0, x0, ch, cw) in f32 arithmetic
    (reference amg.py:276, upstream utils/amg.py:200-234 with n_layers=1),
    x-major as the reference iterates product(x0s, y0s)."""
    f = np.float32
    hf, wf = f(h), f(w)
    overlap = np.floor(f(overlap_ratio) * min(hf, wf))
    crop_w = np.ceil((overlap + wf) / f(2.0))
    crop_h = np.ceil((overlap + hf) / f(2.0))
    boxes = []
    for x0 in (f(0.0), np.floor(crop_w - overlap)):
        for y0 in (f(0.0), np.floor(crop_h - overlap)):
            x1, y1 = min(x0 + crop_w, wf), min(y0 + crop_h, hf)
            boxes.append((float(y0), float(x0), float(y1 - y0), float(x1 - x0)))
    return boxes


def multicrop_frames(image_1024, rh, rw, image_canonical, h, w, sam_cfg: SamConfig, amg_cfg: AmgConfig):
    """The five crops of one image (the full image, then the four layer-1
    crops): each a dict with its point ``grid``, its window in the canonical
    frame (``origin``, ``extent``), its valid extent in SAM's frame (``rhw``)
    and its preprocessed S x S ``frame``."""
    S = sam_cfg.img_size
    grid_crop = build_point_grid(max(int(amg_cfg.points_per_side / amg_cfg.crop_n_points_downscale_factor), 1))
    crops = [dict(grid=build_point_grid(amg_cfg.points_per_side), origin=(0.0, 0.0), extent=(float(h), float(w)),
                  rhw=(rh, rw), frame=preprocess_padded(image_1024, (rh, rw), sam_cfg))]
    image_c = image_canonical.float()
    for cy0, cx0, ch, cw in _crop_boxes_layer1(h, w, amg_cfg.crop_overlap_ratio):
        # cut the crop and long-side-resize it into the (crh, crw) corner of a
        # zero-padded S x S frame (upstream transforms.py:26-31, sam.py:164-174)
        scale = np.float32(S) / np.float32(max(ch, cw))
        crh, crw = (int(np.floor(np.float32(v) * scale + np.float32(0.5))) for v in (ch, cw))
        frame = place_region(image_c, (ch, cw), (S, S), (0, 0), (crh, crw), src_origin=(cy0, cx0))
        crops.append(dict(grid=grid_crop, origin=(cy0, cx0), extent=(ch, cw), rhw=(crh, crw),
                          frame=preprocess_padded(frame, (crh, crw), sam_cfg)))
    return crops


def generate_proposals_multicrop(p_sam, image_1024, rh, rw, image_canonical, h, w, sam_cfg: SamConfig,
                                 amg_cfg: AmgConfig, canonical: int = 1024) -> Proposals:
    """AMG with one crop layer: the full image and 4 overlapping crops
    (reference amg.py:383; upstream automatic_mask_generator.py:197-264).

    image_1024: the full image's padded SAM frame, image_canonical [C, C, 3]
    the canonical frame the crops are cut from, both on the target device.
    Per-crop survivors are capped at ``max_candidates_per_crop``."""
    assert amg_cfg.crop_n_layers == 1, "only crop_n_layers in (0, 1) supported"
    dev = image_1024.device
    K, P, S = amg_cfg.max_candidates_per_crop, amg_cfg.max_proposals, sam_cfg.img_size
    crops = multicrop_frames(image_1024, rh, rw, image_canonical, h, w, sam_cfg, amg_cfg)
    for crop in crops:  # five batch-1 encoder passes, as the reference
        crop["embedding"] = encode(p_sam, crop.pop("frame"), sam_cfg)

    # ---- pass 1 + per-crop NMS into buckets of K
    sel = {k: [] for k in ("boxes", "iou", "stab", "valid", "cand", "crop", "inv_area", "grid")}
    overflow = 0
    for crop_id, crop in enumerate(crops):
        iou, stab, boxes, valid, grid_pts, _ = _score_candidates(
            p_sam, crop["embedding"], crop["grid"], crop["origin"], crop["extent"], crop["rhw"], (h, w),
            sam_cfg, amg_cfg, canonical,
        )
        res = nms(boxes, iou, amg_cfg.box_nms_thresh, valid)
        kept, kv = kept_in_score_order(res, K)
        overflow += max(res.num_kept - K, 0)
        sel["boxes"].append(boxes[kept])
        sel["iou"].append(iou[kept] * kv)
        sel["stab"].append(stab[kept] * kv)
        sel["valid"].append(kv)
        sel["cand"].append(kept)
        sel["crop"].append(torch.full((K,), crop_id, dtype=torch.long, device=dev))
        area = np.float32(crop["extent"][0]) * np.float32(crop["extent"][1])
        sel["inv_area"].append(torch.full((K,), float(np.float32(1.0) / area), device=dev))
        sel["grid"].append(grid_pts)
    boxes_all, iou_all, stab_all, valid_all, cand_all, crop_all, inv_area = (
        torch.cat(sel[k]) for k in ("boxes", "iou", "stab", "valid", "cand", "crop", "inv_area")
    )

    # ---- cross-crop NMS, scored by 1/crop-area (smaller crops win)
    res = nms(boxes_all, inv_area, amg_cfg.crop_nms_thresh, valid_all)
    kept, kept_valid = kept_in_score_order(res, P)
    kept_crop = crop_all[kept]
    kept_point = cand_all[kept] // M
    kept_channel = cand_all[kept] % M

    # ---- pass 2: one batched re-decode, each candidate's crop embedding in
    # the dense-prompt slot (exact: predict_masks adds it to a zero image)
    maxg = max(g.shape[0] for g in sel["grid"])
    grids = torch.stack([torch.nn.functional.pad(g, (0, 0, 0, maxg - g.shape[0])) for g in sel["grid"]])
    geo = torch.tensor([[float(c["rhw"][0]), float(c["rhw"][1]), *c["origin"], *c["extent"]] for c in crops],
                       device=dev)  # rh, rw, y0, x0, ch, cw per crop
    g = geo[kept_crop]
    pts01 = grids[kept_crop, kept_point]
    coords = pts01 * torch.stack([g[:, 1], g[:, 0]], dim=-1)
    sparse = embed_points(p_sam["prompt"], coords[:, None, :], torch.ones((P, 1), device=dev), sam_cfg)
    emb_stack = torch.stack([c["embedding"] for c in crops])
    dense = emb_stack[kept_crop] + no_mask_dense(p_sam["prompt"], sam_cfg, P)
    low_res, _ = predict_masks(p_sam["decoder"], torch.zeros_like(emb_stack[0]), dense_pe(p_sam["prompt"], sam_cfg),
                               sparse, sam_cfg, dense_prompts=dense, multimask_output=True)
    low = low_res[torch.arange(P, device=dev), kept_channel]

    # place each survivor with its own crop's geometry, one batch per crop
    logits = torch.empty((P, canonical, canonical), dtype=torch.float32, device=dev)
    for crop_id, c in enumerate(crops):
        idx = torch.nonzero(kept_crop == crop_id).flatten()
        if idx.numel():
            logits[idx] = place_two_stage(low[idx], S, c["rhw"], (canonical, canonical), c["origin"], c["extent"],
                                          fill=PAD_NEG).float()
    masks = (logits > sam_cfg.mask_threshold) & kept_valid[:, None, None]
    # points in original-image coordinates (the reference uncrops them)
    points = pts01 * torch.stack([g[:, 5], g[:, 4]], dim=-1) + torch.stack([g[:, 3], g[:, 2]], dim=-1)
    kv = kept_valid.float()
    return Proposals(
        masks=masks,
        boxes_xyxy=boxes_all[kept] * kv[:, None],
        iou_preds=iou_all[kept] * kv,
        stability=stab_all[kept] * kv,
        points=points * kv[:, None],
        areas=masks.sum(dim=(-2, -1)).float(),
        valid=kept_valid,
        num=min(max(res.num_kept, 0), P),
        overflow=overflow + max(res.num_kept - P, 0),
    )
