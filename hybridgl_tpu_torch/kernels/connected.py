"""Connected components + small-region mask cleanup on tensors (port of hybridgl_tpu/kernels/connected.py).

An equivalent on tensors of the host pass of pipeline/postprocess.py
(SAM's ``postprocess_small_regions``, automatic_mask_generator.py:323-372 +
utils/amg.py:267-291): fill background components ("holes") smaller than
``min_area``, drop mask components ("islands") smaller than ``min_area``
(keeping the raster-first largest when all are small), then dedup with NMS
preferring unchanged masks.

Connected components are computed by 8-connected min-label propagation with
pointer jumping: each pixel starts with its own flat index, takes the min of
its same-value neighbours (one hop) and then jumps through its current label
(``l = min(l, l.flat[l])``, doubling the effective hop length), in a Python
``while`` until nothing changes: O(log diameter) sweeps over the grid for a
compact component, many more for a wound one. Every
function takes one mask [H, W] or a batch [P, H, W]; a batch is labelled in
one go, each mask with its own flat indices, and the loop reads one flag per
sweep from the device. This is plain PyTorch, no hand-written kernel; the
function names keep the reference's ``_jit`` suffix so that a reader finds
the counterpart. The runner and the data-parallel step call it under
``HYBRIDGL_CLEANUP=device`` and run the native host pass by default: the
sweep count follows the masks, and on speckled masks the loop is ten times
slower than the host pass on an H100 (``PERF.md``); ``chip_smoke.py`` and the
tests hold it equal to the host pass.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .masks import mask_to_box
from .nms import nms

# masks labelled in one batch are bounded by this many pixels (the labels,
# their padded copy, the int64 gather index and a few temporaries take ~30
# bytes a pixel: ~4 GB at the bound)
MAX_BATCH_PIXELS = 2**27


def label_components(working: torch.Tensor) -> torch.Tensor:
    """8-connected components of the True pixels of ``working`` [..., H, W].

    Returns int32 labels of the same shape: the minimum flat (row-major)
    index, within its own mask, of each component (which orders components
    like cv2's raster-scan label assignment) and H*W for pixels outside
    ``working``.
    """
    H, W = working.shape[-2:]
    lead = working.shape[:-2]
    work = working.reshape(-1, H, W)
    BIG = H * W
    flat = torch.arange(BIG, dtype=torch.int32, device=work.device).reshape(1, H, W)
    big = torch.full((), BIG, dtype=torch.int32, device=work.device)
    labels = torch.where(work, flat, big)

    def neighbor_min(l):
        lp = F.pad(l, (1, 1, 1, 1), value=BIG)
        m = l
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                m = torch.minimum(m, lp[:, dy : dy + H, dx : dx + W])
        return torch.where(work, m, big)

    def jump(l):
        lf = l.reshape(l.shape[0], -1)
        j = torch.gather(lf, 1, torch.clamp(lf, max=BIG - 1).long())
        return torch.where(work, torch.minimum(l, j.reshape(l.shape)), big)

    while True:
        nxt = jump(jump(neighbor_min(labels)))
        if not bool((nxt != labels).any()):  # one flag a sweep comes back from the device
            break
        labels = nxt
    return labels.reshape(*lead, H, W)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel size of the component each pixel belongs to ([..., H, W]
    int32; 0 for pixels outside the labelled set)."""
    H, W = labels.shape[-2:]
    HW = H * W
    idx = torch.clamp(labels.reshape(-1, HW), max=HW).long()
    counts = torch.zeros((idx.shape[0], HW + 1), dtype=torch.int32, device=labels.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    counts[:, HW] = 0  # the out-of-set bucket
    return torch.gather(counts, 1, idx).reshape(labels.shape)


def remove_small_regions_jit(mask: torch.Tensor, valid: torch.Tensor, area_thresh, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAM's ``remove_small_regions`` (utils/amg.py:267-291) on the valid
    region of a padded frame. mask [..., H, W] bool, valid [H, W] bool: the
    image's (h, w) region. Returns (mask, changed [...]).

    Pixels outside ``valid`` never connect, so the frame padding cannot
    bridge an edge-touching pocket to the global background: components
    match a full-frame run on the (h, w) image exactly.
    """
    assert mode in ("holes", "islands")
    thresh = int(area_thresh)
    if mode == "holes":
        working = ~mask & valid
        sizes = component_sizes(label_components(working))
        fill = working & (sizes < thresh)
        return mask | fill, fill.any(dim=-1).any(dim=-1)

    working = mask & valid
    labels = label_components(working)
    sizes = component_sizes(labels)
    keep = working & (sizes >= thresh)
    # all-small fallback: keep the largest island; ties go to the component
    # first met in raster order (np.argmax over cv2's labels, because
    # min-flat-index labels share cv2's raster ordering)
    H, W = mask.shape[-2:]
    msize = torch.where(working, sizes, 0).amax(dim=(-2, -1), keepdim=True)
    tied = working & (sizes == msize)
    first_label = torch.where(tied, labels, H * W).amin(dim=(-2, -1), keepdim=True)
    fallback = labels == first_label
    none_kept = ~keep.any(dim=-1).any(dim=-1) & working.any(dim=-1).any(dim=-1)
    new = torch.where(none_kept[..., None, None], working & fallback, keep)
    # 'changed' is raised whenever ANY island was small, even if the
    # keep-largest fallback leaves the mask identical: the flag demotes the
    # mask to score 0 in the dedup NMS, so it must match exactly
    small_any = (working & (sizes < thresh)).any(dim=-1).any(dim=-1)
    return new, small_any


def cleanup_masks_jit(masks: torch.Tensor, prop_valid: torch.Tensor, frame_valid: torch.Tensor, min_area,
                      max_batch_pixels: int = MAX_BATCH_PIXELS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Holes + islands pass over every live proposal. masks [P, H, W] bool,
    prop_valid [P] bool, frame_valid [H, W] bool -> (new_masks [P, H, W],
    changed [P]). Only the live masks are labelled, as many in one batch as
    ``max_batch_pixels`` allows (the reference maps over one mask at a time
    to bound its scratch), and only over the rows and columns that
    ``frame_valid`` reaches: no pixel outside them is ever part of a
    component, and the islands pass leaves none of a live mask's set."""
    P = masks.shape[0]
    live = torch.nonzero(prop_valid).flatten()
    new_masks = masks.clone()
    changed = torch.zeros((P,), dtype=torch.bool, device=masks.device)
    if not bool(frame_valid.any()):  # nothing is inside the image: the islands pass keeps nothing
        new_masks[live] = False
        return new_masks, changed
    h = int(torch.nonzero(frame_valid.any(dim=1)).max()) + 1
    w = int(torch.nonzero(frame_valid.any(dim=0)).max()) + 1
    region = frame_valid[:h, :w]
    step = max(1, max_batch_pixels // (h * w))
    for at in range(0, int(live.numel()), step):
        rows = live[at : at + step]
        m1, c1 = remove_small_regions_jit(masks[rows, :h, :w], region, min_area, "holes")
        m2, c2 = remove_small_regions_jit(m1, region, min_area, "islands")
        new_masks[rows] = False
        new_masks[rows, :h, :w] = m2
        changed[rows] = c1 | c2
    return new_masks, changed


def cleanup_proposals_jit(props, frame_valid: torch.Tensor, min_area, nms_thresh):
    """The device-resident restatement of pipeline/postprocess.py's
    ``postprocess_small_regions``: cleanup + dedup NMS preferring unchanged
    masks (score 1 unchanged, 0 changed; automatic_mask_generator.py:354-363).
    Shapes are kept; suppressed duplicates are invalidated in place exactly
    like the host pass."""
    from ..models.sam.amg import Proposals

    new_masks, changed = cleanup_masks_jit(props.masks, props.valid, frame_valid, min_area)
    new_boxes = mask_to_box(new_masks)
    boxes = torch.where(changed[:, None], new_boxes, props.boxes_xyxy)
    scores = torch.where(changed, 0.0, 1.0)
    res = nms(boxes, scores, nms_thresh, valid=props.valid)
    kept = torch.zeros_like(props.valid)
    kept[res.order] = res.keep_sorted
    valid = props.valid & kept
    masks = new_masks & valid[:, None, None]
    return Proposals(
        masks=masks,
        boxes_xyxy=boxes * valid[:, None],
        iou_preds=props.iou_preds * valid,
        stability=props.stability * valid,
        points=props.points * valid[:, None],
        areas=masks.sum(dim=(-2, -1)).float(),
        valid=valid,
        num=int(valid.sum()),
        overflow=props.overflow,
    )
