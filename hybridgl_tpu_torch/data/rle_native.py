"""The port's own copy of ``hybridgl_tpu/data/rle_native.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

ctypes bindings for the native RLE codec (hybridgl_tpu_torch/native/rle.cpp).

TPU-native counterpart of the reference's vendored pycocotools C codec
(reference: refer/external/mask.py, maskApi.c, built by refer/Makefile).

Auto-builds the shared library on first use (utils/native_build.py, into
hybridgl_tpu_torch/_build/) when a toolchain is present; callers fall back to the numpy implementation
in data/rle.py when unavailable (same results, slower on big masks).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

_SOURCE = "rle.cpp"

_lib: Optional[ctypes.CDLL] = None


def _try_build() -> Optional[str]:
    from ..utils import native_build

    try:
        return str(native_build.build(_SOURCE))
    except Exception:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib_path = _try_build()
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError:
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rle_encode.restype = ctypes.c_int64
    lib.rle_encode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u32p, ctypes.c_int64]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [u32p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int64]
    lib.rle_compress.restype = ctypes.c_int64
    lib.rle_compress.argtypes = [u32p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.rle_decompress.restype = ctypes.c_int64
    lib.rle_decompress.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        u32p,
        ctypes.c_int64,
    ]
    lib.rle_overlap_area.restype = ctypes.c_int64
    lib.rle_overlap_area.argtypes = [u32p, ctypes.c_int64, u32p, ctypes.c_int64, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.uint32))


def encode_counts(mask: np.ndarray) -> Optional[List[int]]:
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = m.shape
    buf = np.empty(h * w + 2, np.uint32)
    n = lib.rle_encode(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        buf.size,
    )
    if n < 0:
        return None
    return buf[:n].tolist()


def decode_counts(counts, h: int, w: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    c = _u32(counts)
    out = np.empty((h, w), np.uint8)
    lib.rle_decode(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        c.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
    )
    return out.astype(bool)


def compress(counts) -> Optional[str]:
    lib = get_lib()
    if lib is None:
        return None
    c = _u32(counts)
    buf = ctypes.create_string_buffer(int(c.size) * 8 + 16)
    n = lib.rle_compress(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), c.size, buf, len(buf)
    )
    if n < 0:
        return None
    return buf.raw[:n].decode("ascii")


def decompress(s) -> Optional[List[int]]:
    lib = get_lib()
    if lib is None:
        return None
    if isinstance(s, str):
        s = s.encode("ascii")
    buf = np.empty(len(s) + 2, np.uint32)
    n = lib.rle_decompress(
        s, len(s), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), buf.size
    )
    if n < 0:
        return None
    return buf[:n].tolist()


def overlap_area(counts_a, counts_b, union: bool) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    a, b = _u32(counts_a), _u32(counts_b)
    return int(
        lib.rle_overlap_area(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            a.size,
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            b.size,
            1 if union else 0,
        )
    )
