"""CLIP self-attention with a CLS-row bias (K6).

:func:`clip_attention` replaces the Pallas kernel of the same name
(``hybridgl_tpu/kernels/clip_attention.py:78``): the ViT-B/16 blocks of the
hybrid fusion stage, up to 2P = 128 crop streams x 12 heads of L = 197
tokens, hd = 64, and CLIP ViT-L/14@336's, 128 streams x 16 heads of L = 577. The additive bias ``cls_bias[n, k]`` applies to query row 0
only, every other row is unbiased (the reference's ``make_attn_mask``,
backbone.py:108-115, arrives compact as [N, L]; see
models/clip/fusion.py:make_cls_bias).

Two kernels stand behind it (:func:`variant` says which a call takes, by
dtype and shape alone, inside the C entry point): bf16 operands with head
dim 64 or 80 and L <= 577 run the resident tensor-core kernel of
``csrc/attention_wgmma.cu`` in CLS_ROW mode (all K and V of a head in shared
memory, the bias added to row 0's f32 accumulator entries; past 256 rows one
block of four warpgroups walks a head's query tiles); f32 operands and the other head dims (16, 32)
run the CUDA-core kernel of ``csrc/attention.cu`` (CLS_ROW mode), which is
exact in f32. The tensor-core kernel rounds the scaled q and the
probabilities to bf16; the bias and all sums stay f32. Past ``MAX_ROWS`` the
model's routing (``models/clip/layers.py``) takes the plain path; GEM's 785
(ViT-B/16) and 1,025 (ViT-L/14@336) tokens have a kernel of their own
(``kernels/gem_attention.py``).

The bias stays f32: masked patches carry ``finfo(float32).min``, which a
cast to bf16 would turn into -inf. Row 0 always attends to itself (bias 0),
so its running max stays finite.

Inputs are q, k, v [N*H, L, hd] (bf16 or f32, unscaled q) and cls_bias
[N, L] f32 or None; the output is [N*H, L, hd]. The wrapper calls its
operator, ``torch.ops.hybridgl.clip_attention`` (``_ops.py``): on a CPU
tensor it runs :func:`reference_clip_attention`; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build, _ops

# the longest sequence K6 takes (models/clip/layers.py routes by it): CLIP
# ViT-L/14@336's 577 tokens; longer ones take the plain path
MAX_ROWS = 577
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80)
TC_HEAD_DIMS = (64, 80)
TC_MAX_ROWS = 577  # the resident kernel keeps a head's K and V in shared memory (148 KB at 577 x 64)


def variant(dtype, L: int, hd: int) -> str:
    """Which path a call of ``L`` tokens takes on the card: "wgmma" or
    "cuda-core" (mirrors ``hgl_cls_tc_takes``, csrc/attention_wgmma.cu), or
    "plain" past ``MAX_ROWS``, where the model does not call K6."""
    if L > MAX_ROWS:
        return "plain"
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and 1 <= L <= TC_MAX_ROWS:
        return "wgmma"
    return "cuda-core"


def reference_clip_attention(q, k, v, cls_bias, num_heads: int, scale: float):
    """Plain PyTorch version of K6: [NH, L, L] f32 scores, bias on row 0."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if cls_bias is not None:
        row0 = s[:, :1] + cls_bias.float().repeat_interleave(num_heads, dim=0)[:, None, :]
        s = torch.cat([row0, s[:, 1:]], dim=1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _launch(q, k, v, cls_bias, num_heads: int, scale: float):
    """The CUDA implementation of K6: check, launch, count."""
    NH, L, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"clip_attention: q/k/v shapes differ {q.shape} {k.shape} {v.shape}")
    if NH % num_heads:
        raise ValueError(f"clip_attention: {NH} rows not divisible by {num_heads} heads")
    if L > MAX_ROWS:
        raise ValueError(f"clip_attention: L={L} > {MAX_ROWS}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"clip_attention: q/k/v must share dtype bf16 or f32, got {q.dtype}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"clip_attention: head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    tensors = [q, k, v]
    if cls_bias is not None:
        if cls_bias.shape != (NH // num_heads, L) or cls_bias.dtype != torch.float32:
            raise ValueError(
                f"clip_attention: cls_bias must be f32 [{NH // num_heads}, {L}], "
                f"got {cls_bias.dtype} {tuple(cls_bias.shape)}"
            )
        tensors.append(cls_bias)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("clip_attention: inputs must be contiguous and on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("clip_attention: q/k/v must be 16-byte aligned (the kernels load 16 bytes a thread)")
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.hgl_cls_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cls_bias.data_ptr() if cls_bias is not None else None,
        out.data_ptr(), NH, L, hd, num_heads, float(scale),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device),
    )
    _build.check(code, "clip_attention")
    clip_attention.launches += 1
    clip_attention.tc_launches += variant(q.dtype, L, hd) == "wgmma"
    return out


_k6 = _ops.define(
    "clip_attention(Tensor q, Tensor k, Tensor v, Tensor? cls_bias, int num_heads, float scale) -> Tensor",
    reference_clip_attention, _launch, lambda q, *_: torch.empty_like(q))


def clip_attention(q, k, v, cls_bias, num_heads: int, scale: float):
    """K6: whole-row softmax attention with the compact CLS-row bias
    (``torch.ops.hybridgl.clip_attention``)."""
    return _k6(q, k, v, cls_bias, int(num_heads), float(scale))


clip_attention.launches = 0
clip_attention.tc_launches = 0  # of those, the launches of csrc/attention_wgmma.cu's resident kernel
