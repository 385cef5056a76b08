"""Build the port's host-side C++ helpers (``hybridgl_tpu_torch/native/*.cpp``).

The counterpart of the reference's ``native/Makefile``: each source is
compiled by the host compiler (``$CXX``, default ``g++``) with the same
flags into a shared library under ``hybridgl_tpu_torch/_build/``, at first
use. The library name carries a hash of its source, so an edited source is
rebuilt and a stale library is never loaded. Nothing is written beside the
sources, and nothing runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]


def library_path(source: str) -> Path:
    """Where the library of ``native/<source>`` is (or will be) built."""
    src = NATIVE_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``native/<source>`` if its library is missing; returns the
    library's path. Raises if the compiler is missing or fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp), str(NATIVE_DIR / source)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if done.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{done.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build of the same source is harmless
    return out
