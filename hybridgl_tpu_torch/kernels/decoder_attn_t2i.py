"""Flash-style token->image cross-attention for the SAM decoder (K8).

:func:`t2i_ctx` replaces the Pallas kernel of the same name
(``hybridgl_tpu/kernels/decoder_attn_t2i.py:82``). The t2i side has ~7
query tokens per head against the S = g*g image keys; side-switched
(``models/sam/decoder.py:_t2i_fused``) the image stream is only read:

    scores[k, (h,t)] = (keys[k] + pe[k]) . qw_b[:, (h,t)]     (scale folded)
    ctx[(h,t), :]    = softmax_k(scores) @ keys

The kernel (T2I mode of ``csrc/decoder_attn_wgmma.cu`` for bf16 at C = 256,
GT = 64 and S a multiple of 64, of the CUDA-core ``csrc/decoder_attn.cu``
otherwise) streams the keys once with a running max, denominator and
[GT, C] accumulator per column, adds pe on the fly (kpe never reaches
device memory), and a combine step merges the row splits. Padding columns
have zero qw: uniform attention, sliced away by the caller. On a CPU
tensor :func:`t2i_ctx` runs :func:`reference_t2i_ctx`.
"""

from __future__ import annotations

import torch

from .decoder_attn import T2I, _f32, _launch


def reference_t2i_ctx(keys, pe, qw):
    """Plain PyTorch version of K8: ctx [B, GT, C] f32 =
    softmax_k(qw . (keys + pe)) @ keys, with kpe, qw and p rounded to keys' dtype."""
    dt = keys.dtype
    kpe = (keys.float() + pe.to(dt).float()).to(dt)
    s = torch.matmul(kpe.float(), qw.to(dt).float())  # [B, S, GT]
    p = torch.exp(s - s.amax(1, keepdim=True))
    ctx = torch.matmul(p.to(dt).float().transpose(1, 2), keys.float())
    return ctx / p.sum(1).clamp(min=1e-30)[..., None]


def t2i_ctx(keys, pe, qw):
    """K8: keys [B, S, C], pe [1 or B, S, C], qw [B, C, GT] f32 -> ctx [B, GT, C] f32."""
    if keys.device.type == "cpu":
        return reference_t2i_ctx(keys, pe, qw)
    if keys.device.type != "cuda":
        raise RuntimeError(f"t2i_ctx: unsupported device {keys.device}")
    B, S, C = keys.shape
    _, ctx = _launch("t2i_ctx", T2I, B, S, C, qside=keys, pe=pe.to(keys.dtype), qw=_f32(qw))
    t2i_ctx.launches += 1
    return ctx


t2i_ctx.launches = 0
