"""CLIP Vision Transformer (port of hybridgl_tpu/models/clip/vit.py).

The reference's modified VisionTransformer (clip/model.py:272-307): blocks
take a per-call attention bias, and ``ln_post`` + projection may apply to
all tokens. Images are NHWC; the stem runs at the param dtype.
"""

from __future__ import annotations

import torch

from ...core.config import ClipConfig

from .layers import layer_norm, residual_attention_block


def vit_stem(p, images: torch.Tensor, cfg: ClipConfig) -> torch.Tensor:
    """conv1 patchify -> +CLS -> +pos -> ln_pre; [N, H, W, 3] -> [N, 1+g^2, width].
    The stride-p pxp conv is a matmul over each patch's (kh, kw, cin) pixels."""
    w = p["conv1"]
    dt = w.dtype
    N, H, W, _ = images.shape
    ps = cfg.patch_size
    gh, gw = H // ps, W // ps
    patches = images.to(dt).reshape(N, gh, ps, gw, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = patches.reshape(N, gh * gw, ps * ps * 3) @ w.reshape(ps * ps * 3, -1)
    cls = p["class_embedding"].to(dt).expand(N, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + p["positional_embedding"].to(dt)
    return layer_norm(p["ln_pre"], x)


def vit_block(p_block, x, cfg: ClipConfig, attn_bias=None, cls_bias=None):
    return residual_attention_block(p_block, x, cfg.vision_heads, attn_bias, cls_bias)


def vit_blocks(p, x, cfg: ClipConfig, start: int = 0, stop=None):
    """Blocks [start, stop) (all by default) without an attention bias."""
    stop = cfg.vision_layers if stop is None else stop
    for i in range(start, stop):
        x = vit_block(p["blocks"][i], x, cfg)
    return x


def vit_head(p, x, cfg: ClipConfig, cls_only: bool = True) -> torch.Tensor:
    """ln_post + proj; [N, embed_dim] f32 CLS features with cls_only."""
    if cls_only:
        x = x[:, 0, :]
    x = layer_norm(p["ln_post"], x)
    return (x @ p["proj"].to(x.dtype)).float()


def encode_image(p, images: torch.Tensor, cfg: ClipConfig, cls_only: bool = True) -> torch.Tensor:
    """The plain CLIP image encoder, the 'crop' fusion mode's path
    (model/backbone.py:126-128 -> clip/model.py:289-307): [N, H, W, 3] ->
    [N, embed_dim] f32 (every token's features without ``cls_only``)."""
    return vit_head(p, vit_blocks(p, vit_stem(p, images, cfg), cfg), cfg, cls_only=cls_only)
