"""Transformer primitives of the CLIP family (port of hybridgl_tpu/models/clip/layers.py).

Math of torch ``nn.MultiheadAttention`` / ``LayerNorm`` as used by the
reference's modified CLIP (clip/model.py:189-257). Attention routing follows
the reference's ``multi_head_attention`` (:81): no ``attn_bias`` and
L <= 512 -> K6 (``clip_attention``, with the optional compact CLS-row bias);
otherwise (the text encoder's causal bias, GEM's 785 tokens) the plain path.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...core.dtypes import score_dtype, softmax_scores
from ...kernels.clip_attention import MAX_ROWS, clip_attention


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm in f32 regardless of the activation dtype (clip/model.py:189-195)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def linear(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def cls_bias_to_attn_bias(cls_bias: torch.Tensor) -> torch.Tensor:
    """Compact CLS-row bias [N, L] -> full additive bias [N, 1, L, L]."""
    N, L = cls_bias.shape
    q_is_cls = (torch.arange(L, device=cls_bias.device) == 0)[None, None, :, None]
    return torch.where(q_is_cls, cls_bias[:, None, None, :], 0.0)


def allowed_mask_to_bias(allowed: torch.Tensor) -> torch.Tensor:
    """Boolean 'may attend' mask -> additive f32 bias (False -> finfo(f32).min)."""
    return torch.where(allowed, 0.0, torch.finfo(torch.float32).min).float()


@functools.lru_cache(maxsize=None)
def _rounded_scale(hd: int, dtype: torch.dtype) -> float:
    """1 / sqrt(hd) rounded to ``dtype``, worked out once on the host (not
    at every block of every image)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd))).to(dtype))


def multi_head_attention(p, x, num_heads: int, attn_bias: Optional[torch.Tensor] = None, cls_bias: Optional[torch.Tensor] = None):
    """Self-attention matching torch nn.MultiheadAttention(d, h); x [N, L, D].

    ``attn_bias``: additive bias broadcastable to [N, H, L, L];
    ``cls_bias``: the compact CLS-row bias [N, L] f32 (exclusive with attn_bias)."""
    N, L, D = x.shape
    H = num_heads
    hd = D // H
    dt = x.dtype
    qkv = x @ p["in_proj_w"].to(dt) + p["in_proj_b"].to(dt)
    scale = hd**-0.5
    if attn_bias is None and L <= MAX_ROWS:

        def heads(t):  # [N, L, D] -> [N*H, L, hd]
            return t.reshape(N, L, H, hd).transpose(1, 2).reshape(N * H, L, hd).contiguous()

        q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
        ctx = clip_attention(q, k, v, cls_bias, H, scale)
        out = ctx.reshape(N, H, L, hd).transpose(1, 2).reshape(N, L, D)
    else:
        if cls_bias is not None:
            assert attn_bias is None, "attn_bias and cls_bias are mutually exclusive"
            attn_bias = cls_bias_to_attn_bias(cls_bias)
        q, k, v = (t.reshape(N, L, H, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        # the reference's rounding points (core/dtypes.py policy): the scale and
        # q * scale round in x's dtype, QK sums in f32 and is stored in the score
        # dtype, the bias is added there (finfo(f32).min becomes -inf under bf16),
        # PV sums in f32 and rounds to x's dtype
        scale_dt = _rounded_scale(hd, dt)
        sdt = score_dtype(dt)
        attn = torch.matmul((q * scale_dt).float(), k.float().transpose(-1, -2)).to(sdt)
        if attn_bias is not None:
            attn = attn + attn_bias.to(sdt)
        attn = softmax_scores(attn).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(N, L, D)
    return out @ p["out_w"].to(dt) + p["out_b"].to(dt)


def residual_attention_block(p, x, num_heads: int, attn_bias=None, cls_bias=None):
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)) with QuickGELU (clip/model.py:244-257)."""
    x = x + multi_head_attention(p["attn"], layer_norm(p["ln_1"], x), num_heads, attn_bias, cls_bias)
    h = linear(p["mlp_fc"], layer_norm(p["ln_2"], x))
    return x + linear(p["mlp_proj"], quick_gelu(h))
