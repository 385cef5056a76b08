"""Greedy box NMS (port of hybridgl_tpu/kernels/nms.py).

torchvision semantics: descending-score order, suppress when IoU > threshold
(strict), kept indices in score order. The reference writes it as one
fixed-shape XLA program on the device (the IoU matrix, then a ``fori_loop``
sweep); it has no Pallas kernel. The port's counterpart is a kernel of its
own, ``csrc/nms.cu``, behind the operator ``torch.ops.hybridgl.nms``
(``_ops.py``): on CUDA tensors it writes the suppression bitmask (one bit a
pair, ``N x ceil(N/64)`` words) and runs the greedy sweep on the card, and
the count stays on the card as an int32 scalar (the reference's
``num_kept``), so a call reads nothing back; on CPU tensors it runs
:func:`reference_nms_sorted`, the same two phases in plain PyTorch.

The score sort and :func:`kept_in_score_order` stay plain torch, as they are
plain XLA in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, _ops
from .masks import box_iou_matrix

NEG = -1e30
MAX_N = 4096 * 64  # hgl_nms_max_n (csrc/nms.cu): the sweep's removed bits fit in 48 KB of shared memory


class NmsResult(NamedTuple):
    order: torch.Tensor  # [N] candidate indices sorted by descending score
    keep_sorted: torch.Tensor  # [N] bool, aligned with `order`
    num_kept: torch.Tensor  # int32 scalar on the boxes' device


def suppression_matrix(b: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The plain bitmask, [N, N] bool: entry (i, j) says that row i, if
    kept, suppresses j (IoU > threshold, compared in f32, and j > i)."""
    N = b.shape[0]
    later = torch.ones((N, N), dtype=torch.bool, device=b.device).triu(1)
    return (box_iou_matrix(b, b) > iou_threshold) & later


def sweep(over: torch.Tensor) -> torch.Tensor:
    """The greedy sweep over a CPU bitmask: [N] bool, suppressed."""
    suppressed = torch.zeros((over.shape[0],), dtype=torch.bool)
    flags = suppressed.numpy()  # a view: the loop reads the flags without a tensor op a row
    for i in range(over.shape[0]):
        if not flags[i]:
            suppressed |= over[i]
    return suppressed


def reference_nms_sorted(b: torch.Tensor, valid: torch.Tensor, iou_threshold: float):
    """Plain PyTorch version of the kernel: boxes [N, 4] and valid [N] in
    descending-score order -> (keep [N] bool, num_kept int32 scalar). The
    sweep runs over every row, valid or not, as the reference's does."""
    suppressed = sweep(suppression_matrix(b, iou_threshold).cpu())
    keep = ~suppressed.to(b.device) & valid
    return keep, keep.sum(dtype=torch.int32)


def _launch(b: torch.Tensor, valid: torch.Tensor, iou_threshold: float):
    """The CUDA implementation: check, launch the mask and sweep kernels, count."""
    if b.dim() != 2 or b.shape[1] != 4 or b.dtype != torch.float32:
        raise ValueError(f"nms: boxes must be f32 [N, 4], got {b.dtype} {tuple(b.shape)}")
    N = b.shape[0]
    if valid.shape != (N,) or valid.dtype != torch.bool:
        raise ValueError(f"nms: valid must be bool [{N}], got {valid.dtype} {tuple(valid.shape)}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"nms: N = {N} outside the kernel's 1..{MAX_N}")
    if valid.device != b.device or not b.is_contiguous() or not valid.is_contiguous():
        raise ValueError("nms: boxes and valid must be contiguous and on one device")
    words = torch.empty((N, -(-N // 64)), dtype=torch.int64, device=b.device)  # the bitmask, scratch
    keep = torch.empty((N,), dtype=torch.bool, device=b.device)
    num = torch.empty((), dtype=torch.int32, device=b.device)
    code = _build.library().hgl_nms(b.data_ptr(), valid.data_ptr(), N, float(iou_threshold), words.data_ptr(),
                                    keep.data_ptr(), num.data_ptr(), _build.stream_handle(b.device))
    _build.check(code, "nms")
    nms.launches += 1
    return keep, num


_n1 = _ops.define(
    "nms(Tensor boxes, Tensor valid, float iou_threshold) -> (Tensor, Tensor)",
    reference_nms_sorted, _launch,
    lambda b, valid, _: (torch.empty_like(valid), b.new_empty((), dtype=torch.int32)))


def nms(boxes, scores, iou_threshold: float, valid=None) -> NmsResult:
    """boxes [N, 4] XYXY, scores [N], valid [N] bool (padding mask)."""
    N = boxes.shape[0]
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=boxes.device)
    s = torch.where(valid, scores, torch.full_like(scores, NEG))
    order = torch.sort(-s, stable=True).indices
    keep_sorted, num_kept = _n1(boxes[order], valid[order], float(iou_threshold))
    return NmsResult(order, keep_sorted, num_kept)


nms.launches = 0


def kept_in_score_order(res: NmsResult, max_out: int):
    """First ``max_out`` kept candidate indices in descending-score order,
    plus a validity mask (reference :82)."""
    pos = torch.sort((~res.keep_sorted).to(torch.uint8), stable=True).indices
    gathered = res.order[pos][:max_out]
    valid = torch.arange(max_out, device=gathered.device) < res.num_kept
    return gathered, valid
