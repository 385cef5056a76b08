"""Small-region mask cleanup on the host (port of hybridgl_tpu/pipeline/postprocess.py:145-272).

For every surviving proposal: fill holes smaller than ``min_area``, drop
islands smaller than ``min_area`` (keeping the largest island if all are
below it), then re-run NMS scoring unchanged masks 1 and changed ones 0, so
duplicates the cleanup created go, untouched masks preferred (reference:
automatic_mask_generator.py:323-372 + utils/amg.py:267-291).

The connected components run in the port's copy of the reference's native
library (``native/region_cleanup.cpp`` through
``postprocess_native.cleanup_batch``), built by the host compiler into
``hybridgl_tpu_torch/_build/`` and loaded once a process. The reference
prefers cv2 where it is importable; the port always runs the native pass
and raises if it cannot be built.
"""

from __future__ import annotations

import os

import numpy as np

from . import postprocess_native

from ..models.sam.amg import Proposals


def cleanup_threads() -> int:
    """Host threads for the cleanup pass: ``$HYBRIDGL_CLEANUP_THREADS``, by
    default the CPU count. The native pass releases the GIL for the length
    of its C call and keeps its scratch per thread, so the bundle's rows are
    split between that many calls."""
    v = os.environ.get("HYBRIDGL_CLEANUP_THREADS")
    if v is not None:
        return max(1, int(v))
    return os.cpu_count() or 1


def _cleanup_batch_threaded(masks, boxes, process, hw, min_area):
    """``postprocess_native.cleanup_batch`` over contiguous row ranges of the
    bundle, one per thread (rows are independent, each range is cleaned in
    place): (changed [P], boxes [P, 4], areas [P]) as one call gives them."""
    live = np.nonzero(process)[0]
    n_threads = min(cleanup_threads(), len(live))
    if n_threads <= 1:
        return postprocess_native.cleanup_batch(masks, boxes, process, hw, min_area)
    from concurrent.futures import ThreadPoolExecutor

    # equal shares of the live rows; masks[a:b] is a contiguous view
    cuts = [int(live[i * len(live) // n_threads]) for i in range(n_threads)] + [len(masks)]
    cuts[0] = 0
    spans = list(zip(cuts[:-1], cuts[1:]))
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        parts = list(pool.map(
            lambda ab: postprocess_native.cleanup_batch(masks[ab[0]:ab[1]], boxes[ab[0]:ab[1]], process[ab[0]:ab[1]],
                                                        hw, min_area), spans))
    return tuple(np.concatenate([part[k] for part in parts]) for k in range(3))


def _np_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float):
    """Greedy host NMS in stable descending-score order."""
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros(len(boxes), bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        for j in order:
            if suppressed[j] or j == i:
                continue
            lt = np.maximum(boxes[i, :2], boxes[j, :2])
            rb = np.minimum(boxes[i, 2:], boxes[j, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[0] * wh[1]
            ai = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            aj = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            union = ai + aj - inter
            if union > 0 and inter / union > thresh:
                suppressed[j] = True
    return keep


def postprocess_small_regions(props: Proposals, min_area: int, nms_thresh: float, hw=None, inplace_masks: bool = False):
    """Host pass over a numpy Proposals bundle -> (props, changed).

    Suppressed duplicates are invalidated in place (shapes kept); changed
    masks and boxes are updated. ``hw`` is the image's (h, w) inside the
    padded canonical frame (connected components must not run across the
    padding). ``changed`` False means nothing was modified or suppressed.
    With ``inplace_masks`` the pass cleans ``props.masks`` itself instead of
    a copy (the runner's cleanup unpacks a buffer of its own an image)."""
    masks = np.asarray(props.masks)
    boxes = np.asarray(props.boxes_xyxy).copy()
    valid = np.asarray(props.valid).copy()
    n = int(props.num)
    if n == 0 or min_area <= 0:
        return props, False
    new_masks = masks if inplace_masks else masks.copy()
    H, W = masks.shape[-2:]
    if hw is not None:
        H, W = int(hw[0]), int(hw[1])
    process = valid & (np.arange(len(masks)) < n)
    changed_flags, nat_boxes, nat_areas = _cleanup_batch_threaded(new_masks, boxes, process, (H, W), min_area)

    idx = [i for i in range(n) if valid[i]]
    nms_boxes = np.stack([nat_boxes[i] if changed_flags[i] else boxes[i] for i in idx])
    scores = np.array([0.0 if changed_flags[i] else 1.0 for i in idx], np.float32)
    keep_set = {idx[k] for k in _np_nms(nms_boxes, scores, nms_thresh)}
    if not (changed_flags.any() or len(keep_set) < len(idx)):
        return props, False
    for pos, i in enumerate(idx):
        if i not in keep_set:
            valid[i] = False
            new_masks[i] = False
        elif changed_flags[i]:
            boxes[i] = nms_boxes[pos]
    # unchanged masks keep their AMG pixel count, changed ones take the
    # native pass's count, suppressed and invalid ones drop to zero
    areas = np.asarray(props.areas, np.float32).copy()
    for i in np.nonzero(changed_flags)[0]:
        areas[i] = nat_areas[i]
    areas[~valid] = 0.0
    out = Proposals(
        masks=new_masks,
        boxes_xyxy=boxes * valid[:, None],
        iou_preds=np.asarray(props.iou_preds) * valid,
        stability=np.asarray(props.stability) * valid,
        points=np.asarray(props.points) * valid[:, None],
        areas=areas,
        valid=valid,
        num=int(valid.sum()),
        overflow=props.overflow,
    )
    return out, True
