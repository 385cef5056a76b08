"""Plain-PyTorch automatic mask generation, after upstream
``segment_anything/automatic_mask_generator.py`` and ``utils/amg.py``, as the
reference configures it (``Hybridgl_main.py:66-74``; PhraseCut
``Hybridgl_main_PhraseCut.py:56-62``): a point grid a crop, crop layers,
multimask decoding, the predicted-IoU and stability filters, the crop-edge
filter, box NMS a crop by predicted IoU, cross-crop NMS by 1 / crop area, and
the small-region cleanup (holes, then islands, then NMS preferring unchanged
masks).

Departures from upstream, each one the reference package's, which the
measured program keeps: empty masks are dropped with the filters (upstream
keeps them with a zero box) and ties in NMS scores keep the lower index.
What differs between SAM's model families is the family's, handed in as an
adapter object (the harness's ``families/<name>.py``): an image's or crop's
frame, its embedding, the decoding of point prompts, and the way from the
decoder's logits back to a crop.
The cleanup labels components with ``scipy.ndimage.label`` at
8-connectivity, as upstream's ``cv2.connectedComponentsWithStats(.., 8)``.
Everything runs in float32 on the device the model is on; nothing of the
measured program is imported.
"""

from __future__ import annotations

import math
from itertools import product
from typing import NamedTuple

import numpy as np
import torch
from scipy import ndimage

EIGHT = np.ones((3, 3), bool)


def point_grid(n: int) -> np.ndarray:
    """Evenly spaced [0, 1]^2 grid, x fastest (upstream utils/amg.py:179-186)."""
    offset = 1 / (2 * n)
    side = np.linspace(offset, 1 - offset, n)
    px = np.tile(side[None, :], (n, 1))
    py = np.tile(side[:, None], (1, n))
    return np.stack([px, py], axis=-1).reshape(-1, 2)


def crop_boxes(h: int, w: int, n_layers: int, overlap_ratio: float):
    """Upstream generate_crop_boxes: [(x0, y0, x1, y1)], layer indices."""
    boxes, layers = [(0, 0, w, h)], [0]
    short = min(h, w)

    def crop_len(orig, n, overlap):
        return int(math.ceil((overlap * (n - 1) + orig) / n))

    for layer in range(n_layers):
        n = 2 ** (layer + 1)
        overlap = int(overlap_ratio * short * (2 / n))
        cw, ch = crop_len(w, n, overlap), crop_len(h, n, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n)]
        y0s = [int((ch - overlap) * i) for i in range(n)]
        for x0, y0 in product(x0s, y0s):
            boxes.append((x0, y0, min(x0 + cw, w), min(y0 + ch, h)))
            layers.append(layer + 1)
    return boxes, layers


def mask_boxes(masks: torch.Tensor) -> torch.Tensor:
    """Upstream batched_mask_to_box: XYXY, inclusive max index, empty -> 0."""
    h, w = masks.shape[-2:]
    rows, cols = masks.any(-1), masks.any(-2)
    hh = torch.arange(h, device=masks.device)
    ww = torch.arange(w, device=masks.device)
    bottom = torch.where(rows, hh, -1).amax(-1)
    top = torch.where(rows, hh, h).amin(-1)
    right = torch.where(cols, ww, -1).amax(-1)
    left = torch.where(cols, ww, w).amin(-1)
    box = torch.stack([left, top, right, bottom], -1).float()
    return torch.where(rows.any(-1)[..., None], box, 0.0)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float, valid=None) -> list:
    """Indices kept by greedy NMS (IoU > thresh suppresses), in score order, ties to the lower index."""
    idx = torch.arange(len(scores), device=scores.device)
    if valid is not None:
        idx = idx[valid]
    if len(idx) == 0:
        return []
    order = idx[torch.sort(scores[idx], descending=True, stable=True).indices]
    b = boxes[order]
    alive = torch.ones(len(order), dtype=torch.bool, device=boxes.device)
    keep = []
    while True:
        rest = torch.nonzero(alive).flatten()
        if len(rest) == 0:
            break
        i = int(rest[0])
        keep.append(int(order[i]))
        alive[i] = False
        alive &= ~(box_iou(b[i: i + 1], b)[0] > thresh)
    return keep


def remove_small_regions(mask: np.ndarray, area: int, mode: str):
    """Upstream utils/amg.py:267-291 (mode "holes" or "islands") -> (mask, changed)."""
    holes = mode == "holes"
    working = holes ^ mask
    regions, n = ndimage.label(working, structure=EIGHT)
    sizes = np.bincount(regions.ravel(), minlength=n + 1)[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area]
    if not small:
        return mask, False
    fill = [0] + small
    if not holes:
        fill = [i for i in range(n + 1) if i not in fill]
        if not fill:
            fill = [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True


def clean(mask: np.ndarray, area: int):
    """Holes then islands -> (mask, changed)."""
    mask, c1 = remove_small_regions(mask, area, "holes")
    mask, c2 = remove_small_regions(mask, area, "islands")
    return mask, c1 or c2


class Crop(NamedTuple):
    box: tuple  # (x0, y0, x1, y1) in the image
    shape: tuple  # (crh, crw): the crop resized into the frame
    points: np.ndarray  # [n, 2] in the crop, before resizing
    embedding: object  # the family's embedding of the crop's frame
    iou: torch.Tensor  # [n * 3]
    stability: torch.Tensor
    boxes: torch.Tensor  # [n * 3, 4] XYXY in the image
    valid: torch.Tensor  # [n * 3] bool


class AmgResult(NamedTuple):
    crops: list
    kept: list  # [(crop, candidate)] after NMS, before the cleanup
    kept_masks: list  # [h, w] bool of each of those, before the cleanup
    masks: list  # [h, w] bool after the cleanup, one a survivor that the cleanup's NMS keeps
    survivors: list  # [(crop, candidate)] of those masks


class ReferenceAMG:
    """The automatic mask generator on a plain float32 SAM of a family (``family``:
    its ``frame``, ``encode``, ``decode`` and ``to_crop``; ``spec``: its settings)."""

    def __init__(self, sam, spec, amg: dict, family, batch: int = 64):
        self.sam, self.spec, self.amg, self.family, self.batch = sam, spec, amg, family, batch
        self.device = next(sam.parameters()).device
        self._embedded = {}

    def _embed(self, image: np.ndarray, full, box):
        """(the frame's content shape (rh, rw), the family's embedding) of one crop box;
        ``full`` (frame, rh, rw) the sample's frame for the full image, None for a crop."""
        x0, y0, x1, y1 = box
        if full is not None:  # the full image: the frame the sample was built with
            frame, rh, rw = full
        else:  # a crop: cut from the image on the device, framed by the family
            cut = torch.from_numpy(np.ascontiguousarray(image[y0:y1, x0:x1])).to(self.device)
            frame, rh, rw = self.family.frame(self.spec, cut)
        return (rh, rw), self.family.encode(self.sam, frame, rh, rw)

    @torch.no_grad()
    def point_candidates(self, image: np.ndarray, full, point) -> list:
        """For a point (image coordinates), [(crop index, predicted IoUs [3],
        stability [3], masks [3, h, w] bool before the cleanup)] of every crop
        whose grid has a point there (within half a pixel)."""
        a = self.amg
        h, w = image.shape[:2]
        boxes, layers = crop_boxes(h, w, a["crop_n_layers"], a["crop_overlap_ratio"])
        found = []
        for ci, (box, layer) in enumerate(zip(boxes, layers)):
            x0, y0, x1, y1 = box
            n_side = int(a["points_per_side"] / a["crop_n_points_downscale_factor"] ** layer)
            grid = point_grid(n_side)
            hit = np.nonzero(np.all(np.abs(grid * np.array([x1 - x0, y1 - y0]) + np.array([x0, y0])
                                           - np.asarray(point, np.float64)) < 0.51, axis=1))[0]
            if not len(hit):
                continue
            if ci not in self._embedded:
                self._embedded[ci] = self._embed(image, full if ci == 0 else None, box)
            shape, emb = self._embedded[ci]
            coords = torch.tensor(grid[hit[:1]] * np.array([shape[1], shape[0]]), dtype=torch.float32,
                                  device=self.device)
            logits, iou = self.family.decode(self.sam, emb, coords)
            m = self.family.to_crop(self.spec, logits, shape, (y1 - y0, x1 - x0))[0]
            thr, off = self.spec.mask_threshold, self.amg["stability_score_offset"]
            stab = (m > thr + off).sum((-1, -2)).float() / (m > thr - off).sum((-1, -2)).float()
            full = torch.zeros((3, h, w), dtype=torch.bool, device=self.device)
            full[:, y0:y1, x0:x1] = m > thr
            found.append((ci, iou[0], stab, full))
        return found

    def forget(self) -> None:
        """Drop the crop embeddings kept for :meth:`point_candidates` (call once an image)."""
        self._embedded = {}

    @torch.no_grad()
    def _crop(self, image: np.ndarray, full, box, n_side: int) -> Crop:
        x0, y0, x1, y1 = box
        ch, cw = y1 - y0, x1 - x0
        shape, emb = self._embed(image, full, box)
        points = point_grid(n_side) * np.array([cw, ch], np.float64)
        coords_all = torch.tensor(point_grid(n_side) * np.array([shape[1], shape[0]]), dtype=torch.float32,
                                  device=self.device)
        a = self.amg
        crop_box = torch.tensor([x0, y0, x1, y1], dtype=torch.float32, device=self.device)
        img_box = torch.tensor([0, 0, image.shape[1], image.shape[0]], dtype=torch.float32, device=self.device)
        ious, stabs, boxes, valids = [], [], [], []
        for s in range(0, len(coords_all), self.batch):
            logits, iou = self.family.decode(self.sam, emb, coords_all[s: s + self.batch])
            m = self.family.to_crop(self.spec, logits, shape, (ch, cw)).flatten(0, 1)
            iou = iou.flatten()
            thr, off = self.spec.mask_threshold, a["stability_score_offset"]
            inter = (m > thr + off).sum((-1, -2)).float()
            union = (m > thr - off).sum((-1, -2)).float()
            stab = inter / union
            binary = m > thr
            del m
            bx = mask_boxes(binary) + crop_box[None, [0, 1, 0, 1]]
            valid = binary.flatten(1).any(-1)
            if a["pred_iou_thresh"] > 0:
                valid &= iou > a["pred_iou_thresh"]
            if a["stability_score_thresh"] > 0:
                valid &= stab >= a["stability_score_thresh"]
            near_crop = torch.isclose(bx, crop_box[None], atol=20.0, rtol=0)
            near_img = torch.isclose(bx, img_box[None], atol=20.0, rtol=0)
            valid &= ~torch.any(near_crop & ~near_img, dim=1)
            ious.append(iou), stabs.append(stab), boxes.append(bx), valids.append(valid)
            del binary
        return Crop(box, shape, points, emb, torch.cat(ious), torch.cat(stabs), torch.cat(boxes),
                    torch.cat(valids))

    @torch.no_grad()
    def candidate_mask(self, crop: Crop, cand: int, h: int, w: int) -> np.ndarray:
        """One candidate's binary mask in the image [h, w], before the cleanup."""
        x0, y0, x1, y1 = crop.box
        pt = torch.tensor(crop.points[cand // 3] * np.array([crop.shape[1] / (x1 - x0), crop.shape[0] / (y1 - y0)]),
                          dtype=torch.float32, device=self.device)
        logits, _ = self.family.decode(self.sam, crop.embedding, pt[None])
        m = self.family.to_crop(self.spec, logits[:, cand % 3: cand % 3 + 1], crop.shape, (y1 - y0, x1 - x0))[0, 0]
        m = m > self.spec.mask_threshold
        full = np.zeros((h, w), bool)
        full[y0:y1, x0:x1] = m.cpu().numpy()
        return full

    @torch.no_grad()
    def run(self, image: np.ndarray, full) -> AmgResult:
        """``image`` [h, w, 3] uint8 at its own resolution, ``full`` the
        sample's frame of it (frame, rh, rw), as the family made it."""
        a = self.amg
        h, w = image.shape[:2]
        boxes, layers = crop_boxes(h, w, a["crop_n_layers"], a["crop_overlap_ratio"])
        crops, kept = [], []
        for ci, (box, layer) in enumerate(zip(boxes, layers)):
            n_side = int(a["points_per_side"] / a["crop_n_points_downscale_factor"] ** layer)
            crop = self._crop(image, full if ci == 0 else None, box, n_side)
            crops.append(crop)
            kept += [(ci, c) for c in greedy_nms(crop.boxes - torch.tensor([box[0], box[1]] * 2, device=self.device),
                                                 crop.iou, a["box_nms_thresh"], crop.valid)]
        if len(crops) > 1 and kept:
            bx = torch.stack([crops[ci].boxes[c] for ci, c in kept])
            area = torch.tensor([float((crops[ci].box[2] - crops[ci].box[0]) * (crops[ci].box[3] - crops[ci].box[1]))
                                 for ci, _ in kept], device=self.device)
            kept = [kept[i] for i in greedy_nms(bx, 1.0 / area, a["crop_nms_thresh"])]
        masks = [self.candidate_mask(crops[ci], c, h, w) for ci, c in kept]
        kept_masks, survivors = list(masks), list(kept)
        if a["min_mask_region_area"] > 0 and kept:
            cleaned, scores = [], []
            for m in masks:
                m2, changed = clean(m, a["min_mask_region_area"])
                cleaned.append(m2)
                scores.append(0.0 if changed else 1.0)
            bx = mask_boxes(torch.from_numpy(np.stack(cleaned)).to(self.device))
            keep = greedy_nms(bx, torch.tensor(scores, device=self.device),
                              max(a["box_nms_thresh"], a["crop_nms_thresh"]))
            masks = [cleaned[i] for i in keep]
            survivors = [kept[i] for i in keep]
        return AmgResult(crops, kept, kept_masks, masks, survivors)
