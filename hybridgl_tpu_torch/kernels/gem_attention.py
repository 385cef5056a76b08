"""GEM's attention (``csrc/gem_attention.cu``): the trunk's softmax attention
and, in the last ``depth`` blocks, the qq/kk/vv self-self ensemble, in one
operator, ``torch.ops.hybridgl.gem_attention``.

Replaces no TPU kernel: the JAX package computes both in plain XLA
(``hybridgl_tpu/models/gem/gem.py``: ``_std_attention``,
``self_self_attention``), and so did the port, with an [L, L] score tensor
in device memory at GEM's 785 (ViT-B/16) and 1,025 (ViT-L/14@336) tokens.
Those plain functions live here, unchanged, and are the operator's CPU
implementation: every CPU test of GEM reads the numbers it read before.

On the card the operator launches or raises (no fallback to plain PyTorch):
bf16 at head dim 64 or 80 runs the tensor-core kernel ``gem_flash`` (one
launch for the trunk and the ensemble, the keys streamed through shared
memory, the scores in f32 registers), every other call (f32, head dims 16
and 32) the CUDA-core kernel ``gem_flash_cc``, exact in f32. With the
ensemble, ``gem_l2norm_rows`` first writes the three streams' unit rows; at
``iters`` > 1 each update pass is one more launch of the kernel with the
normalised stream as V, and one more normalisation (at ``iters`` = 1 the
plain path's last ``_l2norm(attn @ tn)``, which nothing reads, is not
computed). :func:`variant` says which kernel a call takes.

Inputs: q, k, v [N*H, L, hd] (``clip_glue.qkv_heads``' layout, unscaled q),
the number of streams N, the trunk's scale and the ensemble's temperature
(both > 0 on the card), ``iters`` and whether to compute the ensemble.
Output: [E, N, L, H*hd] with the heads merged, E = 2 with the ensemble (the
trunk's context first, the ensemble's mean second), else 1.
"""

from __future__ import annotations

import torch

from ..core.dtypes import score_dtype, softmax_scores
from . import _build, _ops

TC_HEAD_DIMS = (64, 80)
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80)
MODES = {"trunk": 0, "trunk+ensemble": 1, "update": 2}  # hgl_gem_attention's modes
# the device symbols of the three kernels (their names in a profiler trace)
KERNEL_SYMBOLS = ("gem_flash", "gem_flash_cc", "gem_l2norm_rows")


def variant(dtype, hd: int) -> str:
    """Which kernel a call takes on the card: "wgmma" or "cuda-core"
    (mirrors ``hgl_gem_tc_takes``, csrc/gem_attention.cu)."""
    return "wgmma" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "cuda-core"


def _l2norm(t, eps=1e-6):
    # the squares round in t's dtype before the sum, as in the reference's jnp.linalg.norm
    return t / torch.clamp(torch.sqrt((t * t).sum(dim=-1, keepdim=True)), min=eps)


def _scores(a, b, scale, sdt):
    """scale * a b^T with f32 sums, stored in the score dtype (core/dtypes.py)."""
    return (scale * torch.matmul(a.float(), b.float().transpose(-1, -2))).to(sdt)


def self_self_attention(q, k, v, temp: float, iters: int):
    """qq/kk/vv ensemble; returns [N, H, L, hd]."""
    sdt = score_dtype(q.dtype)
    outs = []
    for t in (q, k, v):
        tn = _l2norm(t)
        attn = None
        for _ in range(max(iters, 1)):
            attn = softmax_scores(_scores(tn, tn, temp, sdt)).to(t.dtype)
            tn = _l2norm(torch.matmul(attn, tn))
        outs.append(torch.matmul(attn, v))
    return (outs[0] + outs[1] + outs[2]) / 3.0


def _std_attention(q, k, v, scale):
    attn = softmax_scores(_scores(q, k, scale, score_dtype(q.dtype))).to(v.dtype)
    return torch.matmul(attn, v)


def _merge_heads(t):
    N, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(N, L, H * hd)


def reference_gem_attention(q, k, v, n: int, scale: float, temp: float, iters: int, ensemble: bool):
    """The plain version: ``_std_attention`` of q * scale and, with the
    ensemble, ``self_self_attention``, each with its heads merged."""
    NH, L, hd = q.shape
    q, k, v = (t.reshape(n, NH // n, L, hd) for t in (q, k, v))
    outs = [_merge_heads(_std_attention(q * scale, k, v, 1.0))]
    if ensemble:
        outs.append(_merge_heads(self_self_attention(q, k, v, temp, iters)))
    return torch.stack(outs)


def _launch(q, k, v, n: int, scale: float, temp: float, iters: int, ensemble: bool):
    """The CUDA implementation: check, normalise, launch, count."""
    NH, L, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"gem_attention: q/k/v shapes differ {q.shape} {k.shape} {v.shape}")
    if n < 1 or NH % n:
        raise ValueError(f"gem_attention: {NH} head rows not divisible into {n} streams")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gem_attention: q/k/v must share dtype bf16 or f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"gem_attention: head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if not scale > 0 or (ensemble and not temp > 0):
        raise ValueError(f"gem_attention: scale {scale} and temp {temp} must be > 0 on the card")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gem_attention: q/k/v must be contiguous, 16-byte aligned and on one device")
    lib, st, bf16 = _build.library(), _build.stream_handle(q.device), int(q.dtype == torch.bfloat16)
    out = torch.empty((2 if ensemble else 1, n, L, NH // n * hd), dtype=q.dtype, device=q.device)
    nrm = None
    if ensemble:
        nrm = torch.empty((3, NH, L, hd), dtype=q.dtype, device=q.device)
        _build.check(lib.hgl_gem_l2norm(bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(), nrm.data_ptr(), NH * L, hd, st),
                     "gem_attention (l2norm)")
        for _ in range(max(iters, 1) - 1):  # the update passes: each stream attends into its own unit rows
            ys = torch.empty_like(nrm)
            _build.check(lib.hgl_gem_attention(bf16, None, None, None, nrm.data_ptr(), None, ys.data_ptr(), NH, L, hd,
                                               NH // n, float(scale), float(temp), MODES["update"], st),
                         "gem_attention (update)")
            _build.check(lib.hgl_gem_l2norm(bf16, ys[0].data_ptr(), ys[1].data_ptr(), ys[2].data_ptr(), nrm.data_ptr(),
                                            NH * L, hd, st), "gem_attention (l2norm)")
    code = lib.hgl_gem_attention(bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(), nrm.data_ptr() if ensemble else None,
                                 out[0].data_ptr(), out[1].data_ptr() if ensemble else None, NH, L, hd, NH // n,
                                 float(scale), float(temp), MODES["trunk+ensemble" if ensemble else "trunk"], st)
    _build.check(code, "gem_attention")
    gem_attention.launches += 1
    gem_attention.tc_launches += variant(q.dtype, hd) == "wgmma"
    return out


def _fake(q, k, v, n, scale, temp, iters, ensemble):
    NH, L, hd = q.shape
    return q.new_empty((2 if ensemble else 1, n, L, NH // n * hd))


_op = _ops.define(
    "gem_attention(Tensor q, Tensor k, Tensor v, int n, float scale, float temp, int iters, bool ensemble) -> Tensor",
    reference_gem_attention, _launch, _fake)


def gem_attention(q, k, v, n: int, scale: float, temp: float, iters: int, ensemble: bool):
    """GEM's trunk attention and, with ``ensemble``, its self-self ensemble
    (``torch.ops.hybridgl.gem_attention``): [E, n, L, H*hd]."""
    return _op(q, k, v, int(n), float(scale), float(temp), int(iters), bool(ensemble))


gem_attention.launches = 0  # calls that launched on the card (a call: a normalisation and one launch a pass)
gem_attention.tc_launches = 0  # of those, the calls on the tensor-core kernel
