"""AMG pass-1 statistics (K5, K10).

:func:`pass1_stats_half` replaces the Pallas kernel of the same name
(``hybridgl_tpu/kernels/pass1_stats.py:257``, its ``_stats_call`` with
``pre_half=True``); :func:`pass1_stats` replaces the full mode
(``hybridgl_tpu/kernels/pass1_stats.py:152``, ``pre_half=False``), which
takes the raw logits and runs the column transform inside the kernel. The
main path runs K5, as the reference's does; only the kernel check
(``tools/check_kernels.py``) calls K10. Pass 1 needs four things per (point, mask) candidate:
the two stability threshold counts, the row/column occupancy profiles (for
the box), and non-emptiness. The canonical-frame logits they derive from are
``Wy @ tmp`` where ``tmp = low @ Wx^T`` is the column half-transform (a plain
matmul outside the kernel, :func:`half_transform`); the kernel completes the
row transform one tile at a time inside the placement window and reduces in
place, so the [B, C, C] frame is never stored.

K5 has two kernels (:func:`variant` says which a call takes, by dtype and
shape alone): bf16 stats, the default, run ``csrc/pass1_stats_wgmma.cu`` on
the tensor cores (n a multiple of 16 up to 256, C a multiple of 8); f32 stats
and every other shape run the CUDA-core kernel of ``csrc/pass1_stats.cu``,
which sums in f32 in the plain version's order of magnitude and is held to
equal boxes. K10 has the same two (:func:`variant_full`): in bf16, with n2
held to n's limits, the full mode of ``csrc/pass1_stats_wgmma.cu`` computes
its strip of tmp on the tensor cores and runs K5's sweep on it; f32 stats and
every other shape run ``hgl_pass1_stats_full`` of ``csrc/pass1_stats.cu``.

Dtype policy (reference ``use_bf16_stats``, pass1_stats.py:39-55): the
half-transform and the row matmul take bf16 operands with f32 sums by
default, even with f32 params; ``$HYBRIDGL_STATS_BF16=0`` selects f32.

The window (y0, x0, dh, dw) reaches the kernels as a [4] f32 tensor on the
device (:func:`window_tensor`): a launch captured in the proposal stage's
CUDA graph reads each image's window at replay.

Each wrapper rounds its operands to the stats dtype and calls its operator,
``torch.ops.hybridgl.pass1_stats_half`` or ``.pass1_stats`` (``_ops.py``,
which return the two flag rows as one [2, B, C] tensor): on a CPU tensor it
runs its plain version (:func:`reference_pass1_stats_half`, and for K10
:func:`half_transform` first); on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import torch

from ..utils.env import env_flag
from ..utils.transfer import upload

from . import _build, _ops


def use_bf16_stats() -> bool:
    """bf16 operands for the stats chain (default); opt out with
    ``$HYBRIDGL_STATS_BF16=0`` (same switch as the reference)."""
    return env_flag("HYBRIDGL_STATS_BF16", default=True)


def stats_dtype() -> torch.dtype:
    return torch.bfloat16 if use_bf16_stats() else torch.float32


def half_transform(low: torch.Tensor, WxT: torch.Tensor) -> torch.Tensor:
    """Column half-transform ``low @ WxT`` ([B, n, n2] x [n2, C] -> [B, n, C])
    with operands rounded to the stats dtype, f32 sums, and the result
    stored in the stats dtype (the reference's half_transform_blocked, on
    the interleaved logits)."""
    dt = stats_dtype()
    return torch.matmul(low.to(dt).float(), WxT.to(dt).float()).to(dt)


def window_tensor(window, device) -> torch.Tensor:
    """The placement window (y0, x0, dh, dw) as the kernels read it: four f32
    in device memory, so that a launch captured in a CUDA graph serves every
    image's window. A tensor is used where it is (the proposal stage computes
    its windows on the device); numbers are uploaded without a stream
    synchronisation."""
    if isinstance(window, torch.Tensor):
        return window.to(device=device, dtype=torch.float32).reshape(4).contiguous()
    return upload([float(w) for w in window], device, torch.float32)


def reference_pass1_stats_half(tmp, Wy, window, thresh: float, offset: float):
    """Plain PyTorch version of K5: materialises the [B, C, C] logits."""
    y0, x0, dh, dw = window_tensor(window, tmp.device).unbind()
    C = Wy.shape[0]
    lt = torch.matmul(Wy.float(), tmp.float())  # [B, C, C]
    idx = torch.arange(C, device=tmp.device, dtype=torch.float32)
    valid = ((idx >= y0) & (idx < y0 + dh))[:, None] & ((idx >= x0) & (idx < x0 + dw))[None, :]
    hi = ((lt > thresh + offset) & valid).sum(dim=(-2, -1)).float()
    lo = ((lt > thresh - offset) & valid).sum(dim=(-2, -1)).float()
    m = (lt > thresh) & valid
    return hi / lo.clamp(min=1.0), m.any(dim=-1), m.any(dim=-2)


TC_MAX_N = 256  # the strip and four Wy tiles take 768 n bytes of shared memory


def variant(dtype, n: int, C: int) -> str:
    """Which K5 kernel a CUDA call takes: "wgmma" or "cuda-core". Mirrors
    ``hgl_pass1_stats_tc_takes`` (csrc/pass1_stats_wgmma.cu)."""
    if dtype == torch.bfloat16 and 16 <= n <= TC_MAX_N and n % 16 == 0 and C >= 8 and C % 8 == 0:
        return "wgmma"
    return "cuda-core"


def variant_full(dtype, n: int, n2: int, C: int) -> str:
    """Which K10 kernel a CUDA call takes. Mirrors
    ``hgl_pass1_stats_full_tc_takes`` (csrc/pass1_stats_wgmma.cu)."""
    if variant(dtype, n, C) == "wgmma" and 16 <= n2 <= TC_MAX_N and n2 % 16 == 0:
        return "wgmma"
    return "cuda-core"


def _zeroed_outputs(B: int, C: int, device):
    """(counts [B, 2] int32, flags [2, B, C] bool: row_any, col_any) as views
    of one zeroed buffer: the kernels that meet only in their outputs add to
    the counts and store 1 into the flags."""
    buf = torch.zeros(B * (8 + 2 * C), dtype=torch.uint8, device=device)
    counts = buf[: B * 8].view(torch.int32).view(B, 2)
    return counts, buf[B * 8 :].view(torch.bool).view(2, B, C)


def _stacked(stab, row_any, col_any):
    """The operators' outputs: (stab [B] f32, flags [2, B, C] bool), two
    tensors that do not alias each other (an operator's outputs may not)."""
    return stab, torch.stack([row_any, col_any])


def _fake_stats(B: int, C: int, like):
    return like.new_empty((B,), dtype=torch.float32), like.new_empty((2, B, C), dtype=torch.bool)


def _launch_half(tmp, Wy, window, thresh: float, offset: float):
    """The CUDA implementation of K5: check, launch, count."""
    if tmp.ndim != 3:
        raise ValueError(f"pass1_stats_half: tmp must be [B, n, C], got {tuple(tmp.shape)}")
    B, n, C = tmp.shape
    if Wy.shape != (C, n):
        raise ValueError(f"pass1_stats_half: Wy must be [{C}, {n}], got {tuple(Wy.shape)}")
    if Wy.device != tmp.device:
        raise ValueError("pass1_stats_half: tmp and Wy on different devices")
    dt = tmp.dtype
    if dt not in (torch.bfloat16, torch.float32) or Wy.dtype != dt:
        raise TypeError(f"pass1_stats_half: tmp and Wy must share dtype bf16 or f32, got {dt} {Wy.dtype}")
    if not (tmp.is_contiguous() and Wy.is_contiguous()):
        raise ValueError("pass1_stats_half: inputs must be contiguous")
    tc = variant(dt, n, C) == "wgmma"
    if tc and (tmp.data_ptr() % 16 or Wy.data_ptr() % 16):
        raise ValueError("pass1_stats_half: inputs must be 16-byte aligned (the kernel copies 16 bytes a thread)")
    lib = _build.library()
    entry, tail = (lib.hgl_pass1_stats_tc, ()) if tc else (lib.hgl_pass1_stats, (int(dt == torch.bfloat16),))
    return _launch_stats(pass1_stats_half, tc, B, C, tmp.device, entry, (tmp.data_ptr(), Wy.data_ptr(), B, n, C),
                         window, thresh, offset, tail, f32_counts=not tc)


_k5 = _ops.define(
    "pass1_stats_half(Tensor tmp, Tensor Wy, Tensor window, float thresh, float offset) -> (Tensor, Tensor)",
    lambda tmp, Wy, *a: _stacked(*reference_pass1_stats_half(tmp, Wy, *a)), _launch_half,
    lambda tmp, Wy, *_: _fake_stats(tmp.shape[0], tmp.shape[2], tmp))


def pass1_stats_half(tmp, Wy, window, thresh: float, offset: float):
    """tmp [B, n, C] (pre-applied column half-transform), Wy [C, n] composed
    row weights, window (y0, x0, dh, dw: four numbers or a [4] tensor,
    :func:`window_tensor`) -> (stab [B] f32, row_any [B, C] bool, col_any
    [B, C] bool), stab = hi / max(lo, 1). Both operands are rounded to the
    stats dtype first (``torch.ops.hybridgl.pass1_stats_half``)."""
    dt = stats_dtype()
    stab, flags = _k5(tmp.to(dt), Wy.to(dt), window_tensor(window, tmp.device), float(thresh), float(offset))
    return stab, flags[0], flags[1]


def _launch_stats(wrapper, tc: bool, B: int, C: int, device, entry, operands, window, thresh, offset, tail,
                  f32_counts: bool = False):
    """Launch one pass-1 entry point of the library on zeroed outputs, count
    the launch on ``wrapper`` and turn the two counts into the stability
    score: (stab [B] f32, flags [2, B, C] bool: row_any, col_any). K5's
    CUDA-core kernel stores its counts as f32, the others add integers.
    ``window`` is the [4] f32 device tensor the kernel reads."""
    if window.shape != (4,) or window.dtype != torch.float32 or window.device != device or not window.is_contiguous():
        raise ValueError(f"{wrapper.__name__}: window must be a contiguous [4] f32 on {device}, got {window.dtype} "
                         f"{tuple(window.shape)} on {window.device}")
    counts, flags = _zeroed_outputs(B, C, device)
    if f32_counts:
        counts = counts.view(torch.float32)
    code = entry(*operands, window.data_ptr(), float(thresh), float(offset), counts.data_ptr(), flags[0].data_ptr(),
                 flags[1].data_ptr(), *tail, _build.stream_handle(device))
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    wrapper.tc_launches += int(tc)
    counts = counts.float()
    return counts[:, 0] / counts[:, 1].clamp(min=1.0), flags


# The CUDA-core K10's shared memory: two staging tiles, the [n, 64] column block of tmp
# (f32, n rounded up to 32) and the row flags; the card gives a block 227 KB
_MAX_SMEM_BYTES = 232448


def _launch_full(low, WxT, Wy, window, thresh: float, offset: float):
    """The CUDA implementation of K10: check, launch, count."""
    B, n, n2 = low.shape
    C = WxT.shape[-1]
    dt = low.dtype
    if dt not in (torch.bfloat16, torch.float32) or WxT.dtype != dt or Wy.dtype != dt:
        raise TypeError(f"pass1_stats: low, WxT and Wy must share dtype bf16 or f32, got {dt} {WxT.dtype} {Wy.dtype}")
    low, WxT, Wy = low.contiguous(), WxT.contiguous(), Wy.contiguous()
    if WxT.device != low.device or Wy.device != low.device:
        raise ValueError("pass1_stats: low, WxT and Wy on different devices")
    tc = variant_full(dt, n, n2, C) == "wgmma"
    if tc and (low.data_ptr() % 16 or WxT.data_ptr() % 16 or Wy.data_ptr() % 16):
        raise ValueError("pass1_stats: inputs must be 16-byte aligned (the kernel copies 16 bytes a thread)")
    if not tc:
        n_pad = -(-n // 32) * 32
        smem = (64 * 33 + 32 * 65 + n_pad * 64) * 4 + C * 4
        if smem > _MAX_SMEM_BYTES - 2048:  # static shared memory: flags and the block sums
            raise ValueError(f"pass1_stats: n={n}, C={C} needs {smem} bytes of shared memory per block")
    lib = _build.library()
    entry, tail = (lib.hgl_pass1_stats_full_tc, ()) if tc else (lib.hgl_pass1_stats_full, (int(dt == torch.bfloat16),))
    return _launch_stats(pass1_stats, tc, B, C, low.device, entry,
                         (low.data_ptr(), WxT.data_ptr(), Wy.data_ptr(), B, n, n2, C), window, thresh, offset, tail)


_k10 = _ops.define(
    "pass1_stats(Tensor low, Tensor WxT, Tensor Wy, Tensor window, float thresh, float offset) -> (Tensor, Tensor)",
    lambda low, WxT, Wy, *a: _stacked(*reference_pass1_stats_half(half_transform(low, WxT), Wy, *a)), _launch_full,
    lambda low, WxT, *_: _fake_stats(low.shape[0], WxT.shape[-1], low))


def pass1_stats(low, WxT, Wy, window, thresh: float, offset: float, tile: int = 256):
    """K10: pass-1 stats from the raw logits low [B, n, n2], the column
    weights WxT [n2, C] and the row weights Wy [C, n] -> (stab [B] f32,
    row_any [B, C] bool, col_any [B, C] bool), as :func:`pass1_stats_half`
    of ``half_transform(low, WxT)``: the operands are rounded to the stats
    dtype, tmp = low @ WxT is summed in f32 and rounded to the stats dtype
    (the reference's pass1_stats.py:90-94), then the row product and the
    thresholds (``torch.ops.hybridgl.pass1_stats``). ``tile`` is the TPU
    kernel's row tile; it does not change the result and the CUDA kernel
    tiles by 64."""
    dt = stats_dtype()
    if low.ndim != 3:
        raise ValueError(f"pass1_stats: low must be [B, n, n2], got {tuple(low.shape)}")
    B, n, n2 = low.shape
    C = WxT.shape[-1]
    if WxT.shape != (n2, C):
        raise ValueError(f"pass1_stats: WxT must be [{n2}, C], got {tuple(WxT.shape)}")
    if Wy.shape != (C, n):
        raise ValueError(f"pass1_stats: Wy must be [{C}, {n}], got {tuple(Wy.shape)}")
    stab, flags = _k10(low.to(dt), WxT.to(dt), Wy.to(dt), window_tensor(window, low.device), float(thresh),
                       float(offset))
    return stab, flags[0], flags[1]


pass1_stats_half.launches = 0
pass1_stats_half.tc_launches = 0  # of those, the launches of csrc/pass1_stats_wgmma.cu
pass1_stats.launches = 0
pass1_stats.tc_launches = 0  # of those, the launches of the full mode of csrc/pass1_stats_wgmma.cu
