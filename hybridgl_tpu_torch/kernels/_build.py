"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
at once, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. No PyTorch headers are involved, so a
cold build takes seconds. The build runs
at the first CUDA launch, from the package's own sources, into
``hybridgl_tpu_torch/_build/``; the library name carries a hash of the
sources, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.

Each wrapper passes device pointers and PyTorch's current stream as
``c_void_p`` and raises when the C function returns a CUDA error code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build (None: loaded as built)

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hgl_rel_pos_attention": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _i, _vp],
    "hgl_cls_attention": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _i, _vp],
    "hgl_pass1_stats": [_vp, _vp, _i, _i, _i, _f, _f, _f, _f, _f, _f, _vp, _vp, _vp, _i, _vp],
    "hgl_pass1_stats_full": [_vp, _vp, _vp, _i, _i, _i, _i, _f, _f, _f, _f, _f, _f, _vp, _vp, _vp, _i, _vp],
    "hgl_pass1_stats_tc": [_vp, _vp, _i, _i, _i, _f, _f, _f, _f, _f, _f, _vp, _vp, _vp, _vp],
    "hgl_pass1_stats_tc_takes": [_i, _i],
    "hgl_pass1_stats_tc_smem": [_i],
    "hgl_pass1_stats_full_tc": [_vp, _vp, _vp, _i, _i, _i, _i, _f, _f, _f, _f, _f, _f, _vp, _vp, _vp, _vp],
    "hgl_pass1_stats_full_tc_takes": [_i, _i, _i],
    "hgl_pass1_stats_full_tc_smem": [_i, _i],
    "hgl_cls_tc_takes": [_i, _i],
    "hgl_rel_pos_tc_takes": [_i, _i, _i],
    "hgl_decoder_attn": [_i] + [_vp] * 15 + [_i] * 14 + [_vp],
    "hgl_upscale_hyper": [_vp] * 9 + [_i] * 10 + [_vp],
    "hgl_decoder_attn_tc_takes": [_i] * 10,
    "hgl_decoder_attn_tc_smem": [],
    "hgl_upscale_hyper_tc_takes": [_i] * 5,
    "hgl_upscale_hyper_tc_smem": [],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhybridgl_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the current library is missing; returns its path."""
    global build_seconds
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = nvcc_path()
    objs = [out.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in sources()]
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    log = [" ".join(cmd) + "\n" + text for cmd, text in zip(cmds, outputs)]
    failed = [text for proc, text in zip(procs, outputs) if proc.returncode != 0]
    if not failed:
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp), *map(str, objs)]
        done = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + done.stdout + done.stderr)
        if done.returncode != 0:
            failed.append(done.stderr)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-4000:] for f in failed))
    os.replace(tmp, out)  # atomic: a concurrent build of the same sources is harmless
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hgl_error_string.argtypes = [ctypes.c_int]
        lib.hgl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().hgl_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
