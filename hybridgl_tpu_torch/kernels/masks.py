"""Mask/box analytics of the proposal engine (port of hybridgl_tpu/kernels/masks.py)."""

from __future__ import annotations

import torch


def stability_score(logits: torch.Tensor, mask_threshold: float, offset: float) -> torch.Tensor:
    """IoU between the +offset and -offset thresholdings of mask logits
    [..., H, W] -> [...] (utils/amg.py:156-176: one thresholding contains the
    other, so intersection and union are the two areas)."""
    hi = (logits > (mask_threshold + offset)).sum(dim=(-2, -1))
    lo = (logits > (mask_threshold - offset)).sum(dim=(-2, -1))
    return hi.float() / lo.float()


def box_from_profiles(in_h: torch.Tensor, in_w: torch.Tensor) -> torch.Tensor:
    """XYXY boxes [..., 4] f32 from row/column occupancy profiles; empty -> 0."""
    H, W = in_h.shape[-1], in_w.shape[-1]
    hh = torch.arange(H, device=in_h.device)
    ww = torch.arange(W, device=in_w.device)
    bottom = torch.where(in_h, hh, -1).amax(dim=-1)
    top = torch.where(in_h, hh, H).amin(dim=-1)
    right = torch.where(in_w, ww, -1).amax(dim=-1)
    left = torch.where(in_w, ww, W).amin(dim=-1)
    empty = ~in_h.any(dim=-1)
    box = torch.stack([left, top, right, bottom], dim=-1).float()
    return torch.where(empty[..., None], 0.0, box)


def mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    m = masks.bool()
    return box_from_profiles(m.any(dim=-1), m.any(dim=-2))


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of XYXY boxes (torchvision convention, no +1)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def mask_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of boolean masks [N, H, W] x [M, H, W] -> [N, M], as one
    matmul over the flattened masks."""
    af = a.reshape(a.shape[0], -1).float()
    bf = b.reshape(b.shape[0], -1).float()
    inter = af @ bf.T
    union = af.sum(-1)[:, None] + bf.sum(-1)[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def box_near_crop_edge(boxes: torch.Tensor, crop_box, orig_box, atol: float = 20.0) -> torch.Tensor:
    """Boxes near their crop edge but not near the image edge (utils/amg.py:78-88)."""
    crop = torch.as_tensor(crop_box, dtype=torch.float32, device=boxes.device)
    orig = torch.as_tensor(orig_box, dtype=torch.float32, device=boxes.device)
    near_crop = torch.abs(boxes - crop[None]) <= atol
    near_img = torch.abs(boxes - orig[None]) <= atol
    return torch.any(near_crop & ~near_img, dim=-1)


def box_xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [boxes[..., 0], boxes[..., 1], boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]],
        dim=-1,
    )
