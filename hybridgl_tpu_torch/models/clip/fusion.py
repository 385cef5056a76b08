"""Hybrid global/local fusion scoring (port of hybridgl_tpu/models/clip/fusion.py).

The port has the G2L mode of the reference's ``CLIPViTFM``
(model/backbone.py:227-260), the mode of the RefCOCO main path: blocks
[0, masking_block) run once on the concatenated local + global 2P batch;
from masking_block on, the token-masked global stream is injected into the
local stream while the global stream runs with the CLS-row attention bias.
The other fusion modes are still to be ported (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from hybridgl_tpu.core.config import ClipConfig, CompatConfig

from ...kernels.resize import resize_bilinear
from .layers import allowed_mask_to_bias
from .vit import vit_block, vit_head, vit_stem


def last_layer_index(cfg: ClipConfig) -> int:
    """The reference's ``last_layer`` (10 for ViT-B), generalised as depth - 2."""
    return cfg.vision_layers - 2


def resize_masks_to_grid(pred_masks: torch.Tensor, grid: int, masks_hw=None) -> torch.Tensor:
    """[P, H, W] -> [P, grid, grid] f32 bilinear (backbone.py:160); only the
    valid ``masks_hw`` corner of a padded frame is resized."""
    return resize_bilinear(pred_masks.float(), (grid, grid), src_hw=masks_hw, axis=1)


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
    """Hybrid CLS features [P, embed_dim] for P proposals.

    local_imgs / global_imgs: [P, S, S, 3] NHWC, CLIP-preprocessed;
    pred_masks [P, H, W]; masks_hw the valid extent of a padded frame."""
    if fusion_mode != "G2L":
        raise NotImplementedError(
            f"fusion mode {fusion_mode!r} is not ported yet (the port has G2L); see ROADMAP.md"
        )
    mb = masking_block
    blocks = p_visual["blocks"]
    masks_grid = resize_masks_to_grid(pred_masks, cfg.grid, masks_hw)
    bias = make_cls_bias(masks_grid)

    x = vit_stem(p_visual, local_imgs, cfg)
    x2 = vit_stem(p_visual, global_imgs, cfg)
    # shared trunk on the fused 2P batch
    P = x.shape[0]
    xx = torch.cat([x, x2], dim=0)
    for i in range(mb):
        xx = vit_block(blocks[i], xx, cfg)
    x, x2 = xx[:P], xx[P:]
    for i in range(mb, last_layer_index(cfg) + 2):
        x_ori_global = token_mask(x2, masks_grid)
        x, x2 = vit_block(blocks[i], 2.0 * x_ori_global + x, cfg), vit_block(blocks[i], x2, cfg, cls_bias=bias)
    return vit_head(p_visual, x, cfg)


def calculate_score(image_features, text_features, logit_scale) -> torch.Tensor:
    """Cosine-similarity logits [P, T] scaled by exp(logit_scale) (backbone.py:74-87)."""
    img = image_features / torch.linalg.norm(image_features, dim=-1, keepdim=True)
    txt = text_features / torch.linalg.norm(text_features, dim=-1, keepdim=True)
    return torch.exp(logit_scale) * img @ txt.T
