"""Dataset adapters: REFER / PhraseCut -> the port's ImageSample bundles
(port of hybridgl_tpu/data/datasets.py).

Framework-free iterators over the port's copies of the REFER API
(``data/refer.py``) and the RLE codec (``data/rle.py``); they give the
port's :class:`~hybridgl_tpu_torch.pipeline.runner.ImageSample` with numpy
fields holding the same values as the reference's. ``data/prefetch.py``
overlaps host decode with device work.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
from PIL import Image

from ..data import rle as rle_codec
from ..data.refer import REFER

from ..pipeline.runner import ImageSample


def longest_side_resize(img: np.ndarray, target: int) -> np.ndarray:
    """PIL bilinear longest-side resize (the reference SAM transform,
    utils/transforms.py:26-31 + get_preprocess_shape)."""
    h, w = img.shape[:2]
    scale = target / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def to_padded_frame(img: np.ndarray, frame: int) -> np.ndarray:
    out = np.zeros((frame, frame) + img.shape[2:], img.dtype)
    out[: img.shape[0], : img.shape[1]] = img
    return out


def build_image_sample(image_rgb: np.ndarray, sentences: List[str], gt_mask: Optional[np.ndarray],
                       sam_img_size: int, canonical: int) -> ImageSample:
    """image_rgb [h, w, 3] uint8 and gt_mask [h, w] (or None) -> ImageSample;
    images larger than the canonical frame are downscaled into it."""
    h, w = image_rgb.shape[:2]
    if max(h, w) > canonical:
        scale = canonical / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        image_rgb = np.asarray(Image.fromarray(image_rgb).resize((nw, nh), Image.BILINEAR))
        if gt_mask is not None:
            gt_mask = np.asarray(
                Image.fromarray(gt_mask.astype(np.uint8) * 255).resize((nw, nh), Image.BILINEAR)
            ) > 127
        h, w = nh, nw
    resized = longest_side_resize(image_rgb, sam_img_size)
    rh, rw = resized.shape[:2]
    return ImageSample(
        image_1024=to_padded_frame(resized, sam_img_size),
        rh=rh,
        rw=rw,
        image_canonical=to_padded_frame(image_rgb, canonical),
        h=h,
        w=w,
        gt_mask=to_padded_frame(gt_mask.astype(bool), canonical) if gt_mask is not None else None,
        sentences=sentences,
    )


class ReferDataset:
    """RefCOCO/+/g eval dataset: one ImageSample per ref, all its sentences
    (reference: data/dataset_refer_bert.py). ``prompt_ensemble`` and
    ``coco_instance_gt`` give the reference's optional branches
    (:meth:`ensemble_sentences`, :meth:`instance_annotations`)."""

    templates = (
        "a photo of a {}.",
        "a photo of the {}.",
        "a bad photo of a {}.",
        "a photo of one {}.",
        "a bright photo of the {}.",
        "a cropped photo of a {}.",
        "a close-up photo of the {}.",
    )

    def __init__(self, refer_data_root: str, dataset: str = "refcoco", splitBy: str = "unc", split: str = "val",
                 sam_img_size: int = 1024, canonical: int = 640, prompt_ensemble: bool = False,
                 coco_instance_gt: bool = False):
        self.refer = REFER(refer_data_root, dataset, splitBy)
        self.ref_ids = self.refer.getRefIds(split=split)
        self.sam_img_size = sam_img_size
        self.canonical = canonical
        self.prompt_ensemble = prompt_ensemble
        self.coco_instance_gt = coco_instance_gt

    def __len__(self) -> int:
        return len(self.ref_ids)

    def sentences(self, index: int) -> List[str]:
        ref = self.refer.Refs[self.ref_ids[index]]
        return [s["raw"] for s in ref["sentences"]]

    def ensemble_sentences(self, index: int) -> List[List[str]]:
        """Per-sentence prompt-template expansions."""
        return [[t.format(s) for t in self.templates] for s in self.sentences(index)]

    def instance_annotations(self, index: int) -> Dict:
        """All COCO instance annotations of this ref's image: decoded masks at
        image resolution, xywh boxes, category names."""
        ref = self.refer.Refs[self.ref_ids[index]]
        img_info = self.refer.Imgs[ref["image_id"]]
        h, w = img_info["height"], img_info["width"]
        masks, boxes, cat_names = [], [], []
        for ann in self.refer.imgToAnns.get(ref["image_id"], []):
            seg = ann["segmentation"]
            if isinstance(seg, list) and seg and isinstance(seg[0], list):
                m = rle_codec.polygon_to_mask(seg, h, w)
            else:
                m = rle_codec.decode(seg if isinstance(seg, dict) else {"size": [h, w], "counts": seg})
            masks.append(m.astype(bool))
            boxes.append(np.asarray(ann["bbox"], np.float32))
            cat_names.append(self.refer.Cats[ann["category_id"]])
        return {"masks": masks, "boxes": boxes, "cat_names": cat_names}

    def __getitem__(self, index: int) -> ImageSample:
        ref = self.refer.Refs[self.ref_ids[index]]
        img_info = self.refer.Imgs[ref["image_id"]]
        image = np.asarray(Image.open(os.path.join(self.refer.IMAGE_DIR, img_info["file_name"])).convert("RGB"))
        gt = self.refer.getMask(ref)["mask"] > 0
        return build_image_sample(image, self.sentences(index), gt, self.sam_img_size, self.canonical)

    def __iter__(self) -> Iterator[ImageSample]:
        for i in range(len(self)):
            yield self[i]


# the 80 COCO class names that split PhraseCut tasks into seen (COCO) and
# unseen categories (reference: data/dataset_phrasecut.py:14-27)
COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog",
    "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe",
    "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee",
    "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket",
    "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl",
    "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch",
    "potted plant", "bed", "dining table", "toilet", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock",
    "vase", "scissors", "teddy bear", "hair drier", "toothbrush",
)


def _task_category(task: Dict) -> Optional[str]:
    """The task's instance category name (``category_name``, else the
    phrase structure's name)."""
    if "category_name" in task:
        return task["category_name"]
    ps = task.get("phrase_structure")
    return ps.get("name") if isinstance(ps, dict) else None


class PhraseCutDataset:
    """PhraseCut eval dataset: one ImageSample per (image, phrase) task, from
    the release files (refer_<split>.json + VG images); GT is the union of
    the task's polygons (reference: data/dataset_phrasecut.py:109-122).
    ``seen_mode`` keeps tasks of the 80 COCO classes, ``unseen_mode`` the
    rest (unseen wins if both are set, as the reference's if/elif)."""

    def __init__(self, data_root: str, split: str = "test", sam_img_size: int = 1024, canonical: int = 1024,
                 seen_mode: bool = False, unseen_mode: bool = False):
        self.data_root = data_root
        with open(os.path.join(data_root, f"refer_{split}.json")) as f:
            self.tasks = json.load(f)
        if unseen_mode:
            self.tasks = [t for t in self.tasks if _task_category(t) not in COCO_CLASSES]
        elif seen_mode:
            self.tasks = [t for t in self.tasks if _task_category(t) in COCO_CLASSES]
        self.seen_mode = seen_mode
        self.unseen_mode = unseen_mode
        self.sam_img_size = sam_img_size
        self.canonical = canonical

    def __len__(self) -> int:
        return len(self.tasks)

    def _image_path(self, image_id: int) -> str:
        for sub in ("images/VG_100K", "images/VG_100K_2", "images"):
            p = os.path.join(self.data_root, sub, f"{image_id}.jpg")
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"VG image {image_id} under {self.data_root}")

    def __getitem__(self, index: int) -> ImageSample:
        task = self.tasks[index]
        image = np.asarray(Image.open(self._image_path(task["image_id"])).convert("RGB"))
        h, w = image.shape[:2]
        gt = np.zeros((h, w), bool)
        for polygons in task["Polygons"]:
            for poly in polygons:
                gt |= rle_codec.polygon_to_mask([[c for pt in poly for c in pt]], h, w)
        return build_image_sample(image, [task["phrase"]], gt, self.sam_img_size, self.canonical)

    def __iter__(self) -> Iterator[ImageSample]:
        for i in range(len(self)):
            yield self[i]
