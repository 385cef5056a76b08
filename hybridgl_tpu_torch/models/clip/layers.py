"""Transformer primitives of the CLIP family (port of hybridgl_tpu/models/clip/layers.py).

Math of torch ``nn.MultiheadAttention`` / ``LayerNorm`` as used by the
reference's modified CLIP (clip/model.py:189-257). Attention routing follows
the reference's ``multi_head_attention`` (:81), whose kernel takes L <= 512:
no ``attn_bias`` and L <= ``MAX_ROWS`` (577, CLIP ViT-L/14@336's tokens, so
that its G2L blocks keep the compact CLS-row bias) -> K6 (``clip_attention``,
with the optional compact CLS-row bias; bf16 on the tensor cores, f32 on the
CUDA cores); otherwise (the text encoder's causal bias) the plain path. GEM's
785 and 1,025 tokens run ``kernels/gem_attention.py`` from ``models/gem``.

The glue between the block's matrix products runs as the fused operators of
``kernels/clip_glue.py`` (their plain versions on the CPU): each LayerNorm,
the bias adds with the residual and the next LayerNorm, K6's head split and
merge, and the MLP's bias + QuickGELU. :func:`block_step` also takes the
block's first LayerNorm from the caller and hands the next block's back, so
that a chain of blocks writes each LayerNorm in the kernel that writes the
residual it normalises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...core.dtypes import score_dtype, softmax_scores
from ...kernels import clip_glue
from ...kernels.clip_attention import MAX_ROWS, clip_attention

LN_EPS = clip_glue.LN_EPS


def layer_norm(p, x, eps: float = LN_EPS):
    """LayerNorm in f32 regardless of the activation dtype (clip/model.py:189-195)."""
    return clip_glue.layer_norm(x, p["scale"], p["bias"], eps)


def residual_layer_norm(x, y, b, p_ln):
    """(x + (y + b), its LayerNorm by ``p_ln``), or (x + (y + b), None) without one."""
    if p_ln is None:
        return clip_glue.residual_add(x, y, b), None
    return clip_glue.residual_layer_norm(x, y, b, p_ln["scale"], p_ln["bias"], LN_EPS)


def mlp_residual(p, x, a, p_ln=None):
    """x + mlp_proj(QuickGELU(mlp_fc(a))) and its LayerNorm by ``p_ln`` (None: not computed)."""
    dt = a.dtype
    h = clip_glue.bias_quick_gelu(a @ p["mlp_fc"]["w"].to(dt), p["mlp_fc"]["b"].to(dt))
    return residual_layer_norm(x, h @ p["mlp_proj"]["w"].to(dt), p["mlp_proj"]["b"].to(dt), p_ln)


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


def attention_context(p, a, num_heads: int, attn_bias: Optional[torch.Tensor] = None,
                      cls_bias: Optional[torch.Tensor] = None):
    """Self-attention of the normalised tokens a [N, L, D] up to the
    out-projection: the heads' context merged back to [N, L, D].

    ``attn_bias``: additive bias broadcastable to [N, H, L, L];
    ``cls_bias``: the compact CLS-row bias [N, L] f32 (exclusive with attn_bias)."""
    N, L, D = a.shape
    H = num_heads
    hd = D // H
    dt = a.dtype
    if attn_bias is None and L <= MAX_ROWS:
        q, k, v = clip_glue.qkv_heads(a @ p["in_proj_w"].to(dt), p["in_proj_b"].to(dt), H)
        return clip_glue.merge_heads(clip_attention(q, k, v, cls_bias, H, hd**-0.5), N)
    if cls_bias is not None:
        assert attn_bias is None, "attn_bias and cls_bias are mutually exclusive"
        attn_bias = cls_bias_to_attn_bias(cls_bias)
    qkv = a @ p["in_proj_w"].to(dt) + p["in_proj_b"].to(dt)
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
    return torch.matmul(attn, v).transpose(1, 2).reshape(N, L, D)


def multi_head_attention(p, x, num_heads: int, attn_bias: Optional[torch.Tensor] = None, cls_bias: Optional[torch.Tensor] = None):
    """Self-attention matching torch nn.MultiheadAttention(d, h); x [N, L, D]
    (:func:`attention_context` and the out-projection)."""
    dt = x.dtype
    return attention_context(p, x, num_heads, attn_bias, cls_bias) @ p["out_w"].to(dt) + p["out_b"].to(dt)


def block_step(p, x, num_heads: int, attn_bias=None, cls_bias=None, ln_in=None, ln_next=None):
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)) with QuickGELU
    (clip/model.py:244-257). ``ln_in``: the block's ln_1(x), where the
    caller has it; ``ln_next``: the LayerNorm params to apply to the output.
    Returns (x, ln_next(x)), or (x, None) without ``ln_next``."""
    dt = x.dtype
    a = layer_norm(p["ln_1"], x) if ln_in is None else ln_in
    ctx = attention_context(p["attn"], a, num_heads, attn_bias, cls_bias)
    x, a = residual_layer_norm(x, ctx @ p["attn"]["out_w"].to(dt), p["attn"]["out_b"].to(dt), p["ln_2"])
    return mlp_residual(p, x, a, ln_next)


def residual_attention_block(p, x, num_heads: int, attn_bias=None, cls_bias=None):
    """Pre-LN block (:func:`block_step` without the LayerNorms handed over)."""
    return block_step(p, x, num_heads, attn_bias, cls_bias)[0]
