"""Greedy box NMS (port of hybridgl_tpu/kernels/nms.py).

torchvision semantics: descending-score order, suppress when IoU > threshold
(strict), kept indices in score order. The IoU matrix is built on the
tensors' device; the sequential sweep over it (N is a few hundred) runs on
the host, where a per-candidate loop costs no kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .masks import box_iou_matrix

NEG = -1e30


class NmsResult(NamedTuple):
    order: torch.Tensor  # [N] candidate indices sorted by descending score
    keep_sorted: torch.Tensor  # [N] bool, aligned with `order`
    num_kept: int


def nms(boxes, scores, iou_threshold: float, valid=None) -> NmsResult:
    """boxes [N, 4] XYXY, scores [N], valid [N] bool (padding mask)."""
    N = boxes.shape[0]
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=boxes.device)
    s = torch.where(valid, scores, torch.full_like(scores, NEG))
    order = torch.sort(-s, stable=True).indices
    b = boxes[order]
    iou = box_iou_matrix(b, b).cpu().numpy()
    idx = np.arange(N)
    suppressed = np.zeros((N,), bool)
    for i in range(N):
        if not suppressed[i]:
            suppressed |= (iou[i] > iou_threshold) & (idx > i)
    keep_sorted = torch.from_numpy(~suppressed).to(boxes.device) & valid[order]
    return NmsResult(order, keep_sorted, int(keep_sorted.sum()))


def kept_in_score_order(res: NmsResult, max_out: int):
    """First ``max_out`` kept candidate indices in descending-score order,
    plus a validity mask (reference :82)."""
    pos = torch.sort((~res.keep_sorted).to(torch.uint8), stable=True).indices
    gathered = res.order[pos][:max_out]
    valid = torch.arange(max_out, device=gathered.device) < res.num_kept
    return gathered, valid
