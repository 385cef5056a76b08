"""The port's own copy of ``hybridgl_tpu/data/rle.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

COCO run-length-encoding codec (pure numpy, with optional native core).

Replaces the reference's only native component — the vendored pycocotools
C codec (reference: refer/external/maskApi.c, refer/external/mask.py) —
with (a) a vectorised numpy implementation of the public COCO RLE format
and (b) an optional C++ fast path (native/rle.cpp, loaded via ctypes by
data/rle_native.py) for the hot encode/decode loops.

Format notes (public COCO spec):
  * masks are flattened in Fortran (column-major) order;
  * `counts` alternate runs of 0s and 1s, starting with 0s;
  * the compressed string packs counts 5 bits at a time (LSB first) with a
    continuation bit, offset by 48 into printable ASCII; counts after the
    second are delta-encoded against count[i-2].
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

Rle = Dict[str, Union[List[int], str, tuple]]

_native_mod = None
_native_checked = False


def _native():
    """The ctypes-bound C++ codec, or None (numpy fallback)."""
    global _native_mod, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from . import rle_native

            if rle_native.available():
                _native_mod = rle_native
        except Exception:
            _native_mod = None
    return _native_mod


# ---------------------------------------------------------------------------
# core binary <-> counts
# ---------------------------------------------------------------------------


def encode(mask: np.ndarray) -> Rle:
    """Binary [H, W] mask -> uncompressed RLE dict (counts list)."""
    h, w = mask.shape
    native_counts = _native().encode_counts(mask) if _native() else None
    if native_counts is not None:
        return {"size": [h, w], "counts": native_counts}
    flat = np.asfortranarray(mask.astype(bool)).reshape(-1, order="F")
    # positions where the value changes
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    boundaries = np.concatenate([[0], diff, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [h, w], "counts": counts}


def decode(rle: Rle) -> np.ndarray:
    """RLE dict (counts list or compressed string) -> bool [H, W] mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decompress_counts(counts)
    if _native():
        m = _native().decode_counts(counts, h, w)
        if m is not None:
            return m
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    vals = np.zeros(len(counts), bool)
    vals[1::2] = True
    flat = np.repeat(vals, counts)
    if total < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - total, bool)])
    return flat[: h * w].reshape(h, w, order="F")


def area(rle: Rle) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = decompress_counts(counts)
    return int(sum(counts[1::2]))


def merge(rles: Sequence[Rle], intersect: bool = False) -> Rle:
    """Union (or intersection) of masks, like pycocotools merge."""
    if len(rles) == 1:
        return rles[0]
    acc = decode(rles[0])
    for r in rles[1:]:
        m = decode(r)
        acc = acc & m if intersect else acc | m
    return encode(acc)


def _counts_of(r: Rle):
    c = r["counts"]
    return decompress_counts(c) if isinstance(c, (str, bytes)) else c


def iou(a: Rle, b: Rle) -> float:
    if _native():
        ca, cb = _counts_of(a), _counts_of(b)
        inter = _native().overlap_area(ca, cb, union=False)
        union = _native().overlap_area(ca, cb, union=True)
        if inter is not None and union is not None:
            return float(inter) / float(union) if union else 0.0
    ma, mb = decode(a), decode(b)
    inter = np.logical_and(ma, mb).sum()
    union = np.logical_or(ma, mb).sum()
    return float(inter) / float(union) if union else 0.0


def to_bbox(rle: Rle) -> np.ndarray:
    """RLE -> [x, y, w, h] box."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return np.zeros(4, np.float32)
    return np.array(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1],
        np.float32,
    )


# ---------------------------------------------------------------------------
# compressed counts string
# ---------------------------------------------------------------------------


def compress_counts(counts: Sequence[int]) -> str:
    """counts -> COCO compressed string (delta + 5-bit varint + chr(+48))."""
    if _native():
        s = _native().compress(counts)
        if s is not None:
            return s
    out = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decompress_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    if _native():
        c = _native().decompress(s)
        if c is not None:
            return c
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return counts


# ---------------------------------------------------------------------------
# polygons -> masks
# ---------------------------------------------------------------------------


def polygon_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterise COCO polygon(s) to a bool mask.

    pycocotools traces integer boundaries on a 5x-upsampled grid; we
    rasterise each polygon at 5x with PIL and downsample by point sampling,
    which agrees on all but occasional single boundary pixels.
    """
    from PIL import Image, ImageDraw

    scale = 5
    out = np.zeros((h, w), bool)
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        img = Image.new("1", (w * scale, h * scale), 0)
        draw = ImageDraw.Draw(img)
        draw.polygon(
            [(float(x * scale), float(y * scale)) for x, y in pts],
            outline=1,
            fill=1,
        )
        hi = np.asarray(img, bool)
        # sample the upsampled grid at pixel centers
        out |= hi[scale // 2 :: scale, scale // 2 :: scale][:h, :w]
    return out


def fr_poly_objects(obj, h: int, w: int) -> Rle:
    """frPyObjects equivalent for the formats REFER stores
    (reference: refer/refer.py:277-292): polygon list, RLE dict, or counts
    list."""
    if isinstance(obj, dict):
        return obj  # already RLE
    if isinstance(obj, (list, tuple)) and obj and isinstance(obj[0], (list, tuple, np.ndarray)):
        return encode(polygon_to_mask(obj, h, w))
    if isinstance(obj, (list, tuple)):  # single flat polygon
        return encode(polygon_to_mask([obj], h, w))
    raise TypeError(f"unsupported segmentation object: {type(obj)}")
