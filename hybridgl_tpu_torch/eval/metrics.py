"""IoU metrics (port of hybridgl_tpu/eval/metrics.py).

The accumulator carries cumulative I/U plus the per-sample IoU sum and
count, so oIoU and mIoU follow exactly (reference: utils.py:365-384). A
data-parallel run sums accumulators over its ranks (``parallel/full_eval.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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

    @property
    def overall_iou(self):
        return self.cum_i / self.cum_u

    @property
    def mean_iou(self):
        return self.sum_iou / self.count


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


def update(acc: IoUAccum, pred: torch.Tensor, target: torch.Tensor):
    """(this sample's IoU, the accumulator with it added)."""
    i, u, iou = mask_iou(pred, target)
    return iou, IoUAccum(acc.cum_i + i, acc.cum_u + u, acc.sum_iou + iou, acc.count + 1.0)


def update_masked(acc: IoUAccum, pred, target, enabled) -> IoUAccum:
    """The accumulator with the sample added where ``enabled`` (padded sentences of a batch add nothing)."""
    i, u, iou = mask_iou(pred, target)
    e = torch.as_tensor(enabled, dtype=torch.float32, device=i.device)
    return IoUAccum(acc.cum_i + e * i, acc.cum_u + e * u, acc.sum_iou + e * iou, acc.count + e)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compute_iou(pred, target, cum_i=0.0, cum_u=0.0, mean_iou=None):
    """Signature-compatible helper for users migrating from the reference's
    ``Compute_IoU`` (utils.py:365-384): returns (this_iou, mean_iou_list,
    cum_i, cum_u). The reference's mutable default argument is NOT
    reproduced: pass your own list."""
    if mean_iou is None:
        mean_iou = []
    p, t = _host(pred).astype(bool), _host(target).astype(bool)
    if t.ndim == p.ndim + 1:
        t = t.squeeze(0)
    i = float(np.logical_and(p, t).sum())
    u = float(np.logical_or(p, t).sum())
    this_iou = 0.0 if u == 0 else i / u
    mean_iou.append(this_iou)
    return this_iou, mean_iou, cum_i + i, cum_u + u


def report(acc: IoUAccum) -> dict:
    return {"oIoU": float(acc.overall_iou) * 100.0, "mIoU": float(acc.mean_iou) * 100.0, "count": int(acc.count)}


def a_is_part_of_b(result_seg, this_seg) -> bool:
    """Containment predicate (reference: utils.py:386-395, unused by the
    drivers): A is 'part of' B when at least 90% of A lies inside B and their
    IoU exceeds 0.5."""
    a, b = _host(result_seg).astype(bool), _host(this_seg).astype(bool)
    i = np.logical_and(a, b).sum()
    u = np.logical_or(a, b).sum()
    a_sum = max(int(a.sum()), 1)
    contained = 1.0 - np.logical_and(b, a).sum() / a_sum < 0.1
    return bool(contained and u > 0 and i / u > 0.5)
