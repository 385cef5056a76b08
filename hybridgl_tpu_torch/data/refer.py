"""The port's own copy of ``hybridgl_tpu/data/refer.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

REFER annotation API (RefCOCO / RefCOCO+ / RefCOCOg / RefCLEF).

A fresh implementation of the public REFER dataset interface
(reference: refer/refer.py:40-299): loads ``refs(<splitBy>).p`` +
``instances.json``, builds the index maps, and exposes the same query
surface (getRefIds/getAnnIds/getImgIds/loadRefs/.../getMask) so downstream
code — and users migrating from the reference — keep working. GT masks are
decoded with our numpy/C++ RLE codec instead of pycocotools.
"""

from __future__ import annotations

import itertools
import json
import os.path as osp
import pickle
from typing import Dict, List

import numpy as np

from . import rle as rle_codec


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco", splitBy: str = "unc"):
        self.DATA_DIR = osp.join(data_root, dataset)
        if dataset in ("refcoco", "refcoco+", "refcocog"):
            self.IMAGE_DIR = osp.join(data_root, "images/mscoco/images/train2014")
        elif dataset == "refclef":
            self.IMAGE_DIR = osp.join(data_root, "images/saiapr_tc-12")
        else:
            raise ValueError(f"unknown refer dataset {dataset!r}")
        self.dataset = dataset

        ref_file = osp.join(self.DATA_DIR, f"refs({splitBy}).p")
        with open(ref_file, "rb") as f:
            self.data_refs = pickle.load(f)
        with open(osp.join(self.DATA_DIR, "instances.json")) as f:
            instances = json.load(f)
        self.data_images = instances["images"]
        self.data_annotations = instances["annotations"]
        self.data_categories = instances["categories"]
        self._create_index()

    def _create_index(self):
        self.Anns: Dict = {a["id"]: a for a in self.data_annotations}
        self.Imgs: Dict = {i["id"]: i for i in self.data_images}
        self.Cats: Dict = {c["id"]: c["name"] for c in self.data_categories}
        self.imgToAnns: Dict = {}
        for a in self.data_annotations:
            self.imgToAnns.setdefault(a["image_id"], []).append(a)

        self.Refs, self.imgToRefs, self.refToAnn = {}, {}, {}
        self.annToRef, self.catToRefs = {}, {}
        self.Sents, self.sentToRef, self.sentToTokens = {}, {}, {}
        for ref in self.data_refs:
            rid = ref["ref_id"]
            self.Refs[rid] = ref
            self.imgToRefs.setdefault(ref["image_id"], []).append(ref)
            self.catToRefs.setdefault(ref["category_id"], []).append(ref)
            self.refToAnn[rid] = self.Anns[ref["ann_id"]]
            self.annToRef[ref["ann_id"]] = ref
            for sent in ref["sentences"]:
                self.Sents[sent["sent_id"]] = sent
                self.sentToRef[sent["sent_id"]] = ref
                self.sentToTokens[sent["sent_id"]] = sent["tokens"]

    # -- queries (same split semantics as reference refer.py:141-170) -------
    def getRefIds(self, image_ids=[], cat_ids=[], ref_ids=[], split="") -> List[int]:
        image_ids = image_ids if isinstance(image_ids, list) else [image_ids]
        cat_ids = cat_ids if isinstance(cat_ids, list) else [cat_ids]
        ref_ids = ref_ids if isinstance(ref_ids, list) else [ref_ids]

        refs = self.data_refs
        if image_ids:
            refs = [r for img in image_ids for r in self.imgToRefs.get(img, [])]
        if cat_ids:
            refs = [r for r in refs if r["category_id"] in cat_ids]
        if ref_ids:
            refs = [r for r in refs if r["ref_id"] in ref_ids]
        if split:
            if split in ("testA", "testB", "testC"):
                refs = [r for r in refs if split[-1] in r["split"]]
            elif split in ("testAB", "testBC", "testAC"):
                refs = [r for r in refs if r["split"] == split]
            elif split == "test":
                refs = [r for r in refs if "test" in r["split"]]
            elif split in ("train", "val"):
                refs = [r for r in refs if r["split"] == split]
            else:
                raise ValueError(f"no such split {split!r}")
        return [r["ref_id"] for r in refs]

    def getAnnIds(self, image_ids=[], cat_ids=[], ref_ids=[]) -> List[int]:
        image_ids = image_ids if isinstance(image_ids, list) else [image_ids]
        cat_ids = cat_ids if isinstance(cat_ids, list) else [cat_ids]
        if not (image_ids or cat_ids or ref_ids):
            return [a["id"] for a in self.data_annotations]
        if image_ids:
            anns = list(
                itertools.chain.from_iterable(
                    self.imgToAnns.get(i, []) for i in image_ids
                )
            )
        else:
            anns = self.data_annotations
        if cat_ids:
            anns = [a for a in anns if a["category_id"] in cat_ids]
        return [a["id"] for a in anns]

    def getImgIds(self, ref_ids=[]) -> List[int]:
        ref_ids = ref_ids if isinstance(ref_ids, list) else [ref_ids]
        if ref_ids:
            return list({self.Refs[r]["image_id"] for r in ref_ids})
        return list(self.Imgs.keys())

    def getCatIds(self):
        return list(self.Cats.keys())

    def loadRefs(self, ref_ids=[]):
        if isinstance(ref_ids, int):
            return [self.Refs[ref_ids]]
        return [self.Refs[r] for r in ref_ids]

    def loadAnns(self, ann_ids=[]):
        if isinstance(ann_ids, int):
            return [self.Anns[ann_ids]]
        return [self.Anns[a] for a in ann_ids]

    def loadImgs(self, image_ids=[]):
        if isinstance(image_ids, int):
            return [self.Imgs[image_ids]]
        return [self.Imgs[i] for i in image_ids]

    def loadCats(self, cat_ids=[]):
        if isinstance(cat_ids, int):
            return [self.Cats[cat_ids]]
        return [self.Cats[c] for c in cat_ids]

    def getRefBox(self, ref_id: int):
        return self.refToAnn[ref_id]["bbox"]  # [x, y, w, h]

    def getMask(self, ref) -> Dict:
        """GT mask for a ref (reference: refer.py:277-292): polygons are
        rasterised; multiple parts are summed then binarised."""
        ann = self.refToAnn[ref["ref_id"]]
        image = self.Imgs[ref["image_id"]]
        h, w = image["height"], image["width"]
        seg = ann["segmentation"]
        if isinstance(seg, list) and seg and isinstance(seg[0], list):
            m = rle_codec.polygon_to_mask(seg, h, w)
            a = int(m.sum())
        else:
            r = seg if isinstance(seg, dict) else {"size": [h, w], "counts": seg}
            m = rle_codec.decode(r)
            a = rle_codec.area(r)
        return {"mask": m.astype(np.uint8), "area": a}
