"""Hybrid global/local fusion scoring (port of hybridgl_tpu/models/clip/fusion.py).

The six fusion modes of the reference's ``CLIPViTFM``
(model/backbone.py:117-309):

  crop          plain ViT on the local crops (backbone.py:126-128)
  token_masking patch tokens multiplied by the fractional proposal mask from
                ``masking_block`` on (backbone.py:161-185)
  attn_masking  the CLS row restricted to in-mask patches from
                ``masking_block`` on (backbone.py:187-204); the reference
                returns one block early, reproduced behind
                ``CompatConfig.attn_masking_early_exit``
  L2G           the local stream injected into the attention-masked global
                stream (backbone.py:206-225)
  G2L           the token-masked global stream injected into the local
                stream (backbone.py:227-260), the RefCOCO main path's mode
  G2L&L2G       both directions, four streams, summed heads (backbone.py:262-306)

The two-stream modes run blocks [0, masking_block) once on the concatenated
local + global 2P batch. Every block with the CLS-row mask passes the
compact bias to K6 (``kernels/clip_attention.py``).
"""

from __future__ import annotations

import torch

from ...core.config import ClipConfig, CompatConfig

from ...kernels.resize import resize_bilinear
from .layers import allowed_mask_to_bias, cls_bias_to_attn_bias
from .vit import vit_block, vit_head, vit_stem


def last_layer_index(cfg: ClipConfig) -> int:
    """The reference's ``last_layer`` (10 for ViT-B), generalised as depth - 2."""
    return cfg.vision_layers - 2


def resize_masks_to_grid(pred_masks: torch.Tensor, grid: int, masks_hw=None) -> torch.Tensor:
    """[P, H, W] -> [P, grid, grid] f32 bilinear (backbone.py:160); only the
    valid ``masks_hw`` corner of a padded frame is resized."""
    return resize_bilinear(pred_masks.float(), (grid, grid), src_hw=masks_hw, axis=1)


def make_attn_bias(masks_grid: torch.Tensor) -> torch.Tensor:
    """The full per-proposal bias [P, 1, L, L] (broadcast over heads) of
    ``make_attn_mask`` (backbone.py:108-115): the CLS row may attend to itself
    and to patches with a nonzero (fractional) mask value, patch rows are
    unrestricted. The fusion blocks take its compact row, :func:`make_cls_bias`."""
    return cls_bias_to_attn_bias(make_cls_bias(masks_grid))


def make_cls_bias(masks_grid: torch.Tensor) -> torch.Tensor:
    """Compact CLS-row bias [P, L]: CLS attends to itself and to patches with
    a nonzero (fractional) mask value (make_attn_mask, backbone.py:108-115)."""
    P = masks_grid.shape[0]
    patch_ok = masks_grid.reshape(P, -1) != 0
    allowed = torch.cat([torch.ones((P, 1), dtype=torch.bool, device=patch_ok.device), patch_ok], dim=1)
    return allowed_mask_to_bias(allowed).contiguous()


def token_mask(x: torch.Tensor, masks_grid: torch.Tensor) -> torch.Tensor:
    """Multiply patch tokens by the fractional proposal mask, keep CLS."""
    P = x.shape[0]
    m = masks_grid.reshape(P, -1, 1).to(x.dtype)
    return torch.cat([x[:, :1, :], x[:, 1:, :] * m], dim=1)


def hybrid_forward(p_visual, local_imgs, global_imgs, pred_masks, cfg: ClipConfig, fusion_mode: str = "G2L", masking_block: int = 9, compat: CompatConfig = CompatConfig(), masks_hw=None):
    """Hybrid CLS features [P, embed_dim] for P proposals ('G2L&L2G': the
    sum of its two heads, as the reference).

    local_imgs / global_imgs: [P, S, S, 3] NHWC, CLIP-preprocessed;
    pred_masks [P, H, W]; masks_hw the valid extent of a padded frame."""
    mb = masking_block
    last = last_layer_index(cfg)
    blocks = p_visual["blocks"]

    def run(x, start, stop, bias=None):
        for i in range(start, stop):
            x = vit_block(blocks[i], x, cfg, cls_bias=bias)
        return x

    if fusion_mode == "crop":
        return vit_head(p_visual, run(vit_stem(p_visual, local_imgs, cfg), 0, cfg.vision_layers), cfg)
    if fusion_mode not in ("token_masking", "attn_masking", "L2G", "G2L", "G2L&L2G"):
        raise ValueError(f"unknown fusion mode {fusion_mode!r}")

    masks_grid = resize_masks_to_grid(pred_masks, cfg.grid, masks_hw)
    x = vit_stem(p_visual, local_imgs, cfg)
    if fusion_mode == "token_masking":
        x = run(x, 0, mb)
        for i in range(mb, last + 2):
            x = vit_block(blocks[i], token_mask(x, masks_grid), cfg)
        return vit_head(p_visual, x, cfg)
    bias = make_cls_bias(masks_grid)
    if fusion_mode == "attn_masking":
        stop = last + 1 if compat.attn_masking_early_exit else last + 2
        return vit_head(p_visual, run(run(x, 0, mb), mb, stop, bias), cfg)

    # two-stream modes: shared trunk on the fused 2P batch
    x2 = vit_stem(p_visual, global_imgs, cfg)
    P = x.shape[0]
    xx = run(torch.cat([x, x2], dim=0), 0, mb)
    x, x2 = xx[:P], xx[P:]
    xh_local, xh_global = x, x2  # G2L&L2G's hybrid streams
    for i in range(mb, last + 2):
        blk = blocks[i]
        if fusion_mode == "L2G":
            x, x2 = vit_block(blk, x, cfg), vit_block(blk, x + 2.0 * x2, cfg, cls_bias=bias)
        elif fusion_mode == "G2L":
            x, x2 = vit_block(blk, 2.0 * token_mask(x2, masks_grid) + x, cfg), vit_block(blk, x2, cfg, cls_bias=bias)
        else:  # G2L&L2G
            x_ori_global = token_mask(x2, masks_grid)
            x, x2, xh_local, xh_global = (
                vit_block(blk, x, cfg),
                vit_block(blk, x2, cfg, cls_bias=bias),
                vit_block(blk, xh_local + 2.0 * x_ori_global, cfg),
                vit_block(blk, x + 2.0 * xh_global, cfg, cls_bias=bias),
            )
    if fusion_mode == "L2G":
        return vit_head(p_visual, x2, cfg)
    if fusion_mode == "G2L":
        return vit_head(p_visual, x, cfg)
    return vit_head(p_visual, xh_local, cfg) + vit_head(p_visual, xh_global, cfg)


def calculate_score(image_features, text_features, logit_scale) -> torch.Tensor:
    """Cosine-similarity logits [P, T] scaled by exp(logit_scale) (backbone.py:74-87)."""
    img = image_features / torch.linalg.norm(image_features, dim=-1, keepdim=True)
    txt = text_features / torch.linalg.norm(text_features, dim=-1, keepdim=True)
    return torch.exp(logit_scale) * img @ txt.T
