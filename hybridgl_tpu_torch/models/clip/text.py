"""CLIP text transformer (port of hybridgl_tpu/models/clip/text.py; encode_text,
reference clip/model.py:414-431)."""

from __future__ import annotations

import torch

from ...core.config import ClipConfig

from .layers import layer_norm, residual_attention_block


def causal_bias(context_length: int, device="cpu") -> torch.Tensor:
    """Additive causal mask [1, 1, L, L] (clip/model.py:396-402)."""
    neg = torch.finfo(torch.float32).min
    m = torch.triu(torch.full((context_length, context_length), neg, device=device), diagonal=1)
    return m[None, None]


def encode_text(p, tokens: torch.Tensor, cfg: ClipConfig) -> torch.Tensor:
    """tokens [N, context_length] int -> [N, embed_dim] f32 features, pooled
    at the EOT token (the highest token id)."""
    emb = p["token_embedding"]
    # ids past the vocabulary read its last row, as the reference's jnp gather
    # clamps them: only the test-tiny vocab (101 ids) under the full BPE
    # tokenizer meets this (cli/main.py's test-tiny smoke config)
    x = emb[tokens.long().clamp(max=emb.shape[0] - 1)] + p["positional_embedding"].to(emb.dtype)
    bias = causal_bias(cfg.context_length, tokens.device)
    for blk in p["blocks"]:
        x = residual_attention_block(blk, x, cfg.text_heads, bias)
    x = layer_norm(p["ln_final"], x)
    pool = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), pool]
    return (x @ p["text_projection"].to(x.dtype)).float()
