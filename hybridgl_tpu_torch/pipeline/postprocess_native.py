"""The port's own copy of ``hybridgl_tpu/pipeline/postprocess_native.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

ctypes bindings for the native small-region cleanup
(hybridgl_tpu_torch/native/region_cleanup.cpp), built at first use into
hybridgl_tpu_torch/_build/ by utils/native_build.py.

Drop-in fast path for pipeline/postprocess.py's per-mask crop loop: one C
call handles the whole proposal bundle (two union-find labelings per mask,
in place on the strided crop windows) instead of 2 cv2 calls plus ~6 numpy
passes per mask. ``cleanup_batch`` returns None when the library is
unavailable; the port's only caller (pipeline/postprocess.py) builds the
library itself first and raises with the compiler's message, it never takes
the cv2 path.

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
from typing import Optional, Tuple

import numpy as np

_SOURCE = "region_cleanup.cpp"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _try_build() -> Optional[str]:
    from ..utils import native_build

    try:
        return str(native_build.build(_SOURCE))
    except Exception:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from ..utils.env import env_flag

    if env_flag("HYBRIDGL_NO_NATIVE_CLEANUP"):
        return None
    if not env_flag("HYBRIDGL_FORCE_NATIVE_CLEANUP"):
        # cv2 5.0's block-based labeling (SIMD Spaghetti) measured faster
        # than this union-find on both noise-dense (847 vs 1156 ms) and
        # compact-blob (110 vs 138 ms) bundles on the single-core host, so
        # the native pass serves as the cv2-free fallback, not the default.
        try:
            import cv2  # noqa: F401

            return None
        except ImportError:
            pass
    lib_path = _try_build()
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
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
    _lib = lib
    return _lib


def cleanup_batch(
    masks: np.ndarray,  # [P, H, W] bool — MUTATED in place (as uint8 view)
    boxes: np.ndarray,  # [P, 4] float32 xyxy
    valid: np.ndarray,  # [P] bool
    img_hw: Tuple[int, int],
    min_area: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Runs the native pass; returns (changed [P] bool, new_boxes [P, 4]
    float32, new_areas [P] int64) or None when the library is unavailable.
    Only changed rows of new_boxes/new_areas are meaningful."""
    lib = get_lib()
    if lib is None:
        return None
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
