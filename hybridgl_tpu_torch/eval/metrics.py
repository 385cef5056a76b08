"""IoU metrics (port of hybridgl_tpu/eval/metrics.py).

The accumulator carries cumulative I/U plus the per-sample IoU sum and
count, so oIoU and mIoU follow exactly (reference: utils.py:365-384).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IoUAccum(NamedTuple):
    cum_i: torch.Tensor
    cum_u: torch.Tensor
    sum_iou: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def zeros(device="cpu"):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return IoUAccum(z, z, z, z)


def mask_iou(pred: torch.Tensor, target: torch.Tensor):
    """(I, U, IoU) of two boolean masks; U == 0 -> IoU 0."""
    p, t = pred.bool(), target.bool()
    i = (p & t).sum().float()
    u = (p | t).sum().float()
    iou = torch.where(u == 0, 0.0, i / torch.clamp(u, min=1.0))
    return i, u, iou


def accumulate(acc: IoUAccum, iu) -> IoUAccum:
    i, u, iou = iu
    return IoUAccum(acc.cum_i + i, acc.cum_u + u, acc.sum_iou + iou, acc.count + 1.0)
