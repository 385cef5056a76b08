"""Referring samples made from the seed: images, ground-truth regions and
expressions, as the measured program's ``ImageSample`` takes them.

``to_padded_frame`` and ``build_image_sample`` are a frozen copy of the
program's sample builder (``data/datasets.py``), which returns the program's
own ``ImageSample`` type; the copy returns the same fields as a plain tuple
of this module, which the harness converts. The proposal model's frame is its
family's (``families/<name>.py:frame``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
from PIL import Image


class Sample(NamedTuple):
    image_1024: np.ndarray  # [S, S, 3] uint8, the proposal model's frame (its family's)
    rh: int
    rw: int
    image_canonical: np.ndarray  # [C, C, 3] uint8
    h: int
    w: int
    gt_mask: Optional[np.ndarray]  # [C, C] bool
    sentences: List[str]


def to_padded_frame(img: np.ndarray, frame: int) -> np.ndarray:
    out = np.zeros((frame, frame) + img.shape[2:], img.dtype)
    out[: img.shape[0], : img.shape[1]] = img
    return out


def build_image_sample(image_rgb: np.ndarray, sentences: List[str], gt_mask: Optional[np.ndarray],
                       frame: Callable, canonical: int) -> Sample:
    """``frame(image) -> (frame [S, S, 3] uint8, rh, rw)``: the proposal model's frame of the image."""
    h, w = image_rgb.shape[:2]
    if max(h, w) > canonical:
        scale = canonical / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        image_rgb = np.asarray(Image.fromarray(image_rgb).resize((nw, nh), Image.BILINEAR))
        if gt_mask is not None:
            gt_mask = np.asarray(Image.fromarray(gt_mask.astype(np.uint8) * 255).resize((nw, nh), Image.BILINEAR)) > 127
        h, w = nh, nw
    framed, rh, rw = frame(image_rgb)
    return Sample(framed, rh, rw, to_padded_frame(image_rgb, canonical), h, w,
                  to_padded_frame(gt_mask.astype(bool), canonical) if gt_mask is not None else None, sentences)


# ---------------------------------------------------------------------------
# synthetic scenes
# ---------------------------------------------------------------------------


def region(h: int, w: int, kind: int, cy: float, cx: float, ry: float, rx: float) -> np.ndarray:
    """[h, w] bool rectangle (kind 0) or ellipse (kind 1), centre and half-extents in pixels."""
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    if kind == 0:
        return (np.abs(y - cy) <= ry) & (np.abs(x - cx) <= rx)
    return ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0


def random_region(rng: np.random.Generator, h: int, w: int, lo: float = 0.08, hi: float = 0.45) -> np.ndarray:
    """An object-like region: a rectangle or an ellipse of 8-45% of each side, inside the image."""
    ry, rx = rng.uniform(lo, hi) * h / 2, rng.uniform(lo, hi) * w / 2
    cy, cx = rng.uniform(ry, h - ry), rng.uniform(rx, w - rx)
    return region(h, w, int(rng.integers(2)), cy, cx, ry, rx)


def scene(rng: np.random.Generator, h: int, w: int, n_objects: int):
    """An image [h, w, 3] uint8 of a smooth background and ``n_objects``
    coloured regions with some texture, and the first region (the referred
    object)."""
    coarse = rng.uniform(40, 215, (4, 5, 3)).astype(np.float32)
    img = np.asarray(Image.fromarray(coarse.astype(np.uint8)).resize((w, h), Image.BILINEAR), np.float32)
    first = None
    for _ in range(n_objects):
        m = random_region(rng, h, w)
        img[m] = rng.uniform(0, 255, 3).astype(np.float32)
        first = m if first is None else first
    img += rng.normal(0, 6, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), first


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

NOUNS = ["man", "woman", "dog", "cat", "car", "chair", "table", "umbrella", "horse", "bus", "girl", "boy", "bottle",
         "bench", "truck", "sheep", "cow", "bird", "plate", "cup", "bike", "elephant", "giraffe", "pizza"]
ADJECTIVES = ["red", "white", "black", "blue", "green", "old", "young", "striped", "wooden", "tall", "little"]
DIRECTIONS = ["on the left", "on the right", "in the middle", "at the top", "at the bottom", "left", "right"]
RELATIONS = ["bigger", "larger", "closer", "smaller", "tinier", "further"]
PREPOSITIONS = ["next to", "behind", "under", "near", "with", "beside", "above", "below", "in front of", "inside"]


def expression(rng: np.random.Generator, n_others: int) -> str:
    """A referring expression: an adjective or a relation word, a head noun,
    an optional direction phrase, and ``n_others`` other nouns after
    prepositions (the parser's direction, relation and noun cases)."""
    words = []
    if rng.random() < 0.25:
        words += ["the", str(rng.choice(RELATIONS))]
    elif rng.random() < 0.7:
        words += [str(rng.choice(["the", "a"])), str(rng.choice(ADJECTIVES))]
    words.append(str(rng.choice(NOUNS)))
    for k in range(n_others):
        words += [str(rng.choice(PREPOSITIONS)), "the" if k == 0 else "a", str(rng.choice(NOUNS))]
    if rng.random() < 0.45:
        words.append(str(rng.choice(DIRECTIONS)))
    return " ".join(words)
