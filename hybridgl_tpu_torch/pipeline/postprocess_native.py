"""The port's copy of ``hybridgl_tpu/pipeline/postprocess_native.py``: the
same C entry point and semantics, built and loaded by the port itself, so
that the port imports nothing of the JAX package.

ctypes bindings for the native small-region cleanup
(hybridgl_tpu_torch/native/region_cleanup.cpp), built at first use into
hybridgl_tpu_torch/_build/ by utils/native_build.py and loaded once a
process.

One C call handles the whole proposal bundle (two union-find labelings per
mask, in place on the strided crop windows). The reference prefers cv2
where it is importable; the port always runs this pass, and a missing or
failing compiler raises with the compiler's message.

Byte-identical to the cv2 path except one documented corner: when the
all-small islands fallback has a TIED max size, the native pass keeps the
raster-first tied component deterministically, while cv2's np.argmax
winner depends on cv2's implementation-defined label order (the reference
inherits the same arbitrariness). See tests/test_postprocess_native.py.

Reference semantics: automatic_mask_generator.py:323-372 +
utils/amg.py:267-291 (see postprocess.py for the crop-window argument).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

_SOURCE = "region_cleanup.cpp"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()  # the cleanup's threads reach the first load together


def get_lib() -> ctypes.CDLL:
    """The native library, built and loaded at the first call of the
    process; the other callers wait for it. Raises if it cannot be built or
    loaded (the next call tries again)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load()
        return _lib


def _load() -> ctypes.CDLL:
    from ..utils import native_build

    lib = ctypes.CDLL(str(native_build.build(_SOURCE)))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.region_cleanup_batch.restype = ctypes.c_int64
    lib.region_cleanup_batch.argtypes = [
        u8p,  # masks [P, H, W]
        ctypes.c_int64,  # P
        ctypes.c_int64,  # H
        ctypes.c_int64,  # W
        f32p,  # boxes [P, 4]
        u8p,  # valid [P]
        ctypes.c_int64,  # img_h
        ctypes.c_int64,  # img_w
        ctypes.c_int64,  # min_area
        u8p,  # changed [P] out
        f32p,  # out_boxes [P, 4]
        i64p,  # out_areas [P]
    ]
    return lib


def cleanup_batch(
    masks: np.ndarray,  # [P, H, W] bool — MUTATED in place (as uint8 view)
    boxes: np.ndarray,  # [P, 4] float32 xyxy
    valid: np.ndarray,  # [P] bool
    img_hw: Tuple[int, int],
    min_area: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Runs the native pass; returns (changed [P] bool, new_boxes [P, 4]
    float32, new_areas [P] int64). Only changed rows of new_boxes/new_areas
    are meaningful."""
    lib = get_lib()
    m = np.ascontiguousarray(masks).view(np.uint8)
    b = np.ascontiguousarray(boxes, dtype=np.float32)
    v = np.ascontiguousarray(valid).view(np.uint8)
    P, H, W = m.shape
    changed = np.zeros(P, np.uint8)
    out_boxes = np.zeros((P, 4), np.float32)
    out_areas = np.zeros(P, np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.region_cleanup_batch(
        m.ctypes.data_as(u8p),
        P,
        H,
        W,
        b.ctypes.data_as(f32p),
        v.ctypes.data_as(u8p),
        int(img_hw[0]),
        int(img_hw[1]),
        int(min_area),
        changed.ctypes.data_as(u8p),
        out_boxes.ctypes.data_as(f32p),
        out_areas.ctypes.data_as(i64p),
    )
    if m.base is not masks and m.ctypes.data != masks.ctypes.data:
        masks[...] = m.view(bool)  # ascontiguousarray copied; write back
    return changed.view(bool), out_boxes, out_areas
