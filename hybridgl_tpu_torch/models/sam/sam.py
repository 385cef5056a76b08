"""SAM composite: preprocessing + prompted prediction (port of hybridgl_tpu/models/sam/sam.py)."""

from __future__ import annotations

import torch

from ...core.config import SamConfig

from .decoder import predict_masks
from .image_encoder import encode_image
from .prompt_encoder import dense_pe, embed_points, no_mask_dense


def preprocess_padded(image_1024: torch.Tensor, valid_hw, cfg: SamConfig) -> torch.Tensor:
    """Normalize an already padded [S, S, 3] frame and zero the pad
    (reference sam.py:164-174: the pad is 0 in normalized space)."""
    dev = image_1024.device
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=dev)
    x = (image_1024.float() - mean) / std
    i = torch.arange(cfg.img_size, device=dev)
    valid = (i[:, None] < int(valid_hw[0])) & (i[None, :] < int(valid_hw[1]))
    return torch.where(valid[..., None], x, 0.0)


def encode(p_sam, image_1024: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """Preprocessed [S, S, 3] -> image embedding [g, g, prompt_dim]."""
    return encode_image(p_sam["encoder"], image_1024[None], cfg)[0]


def predict_points(p_sam, embedding, point_coords, point_labels, cfg: SamConfig, multimask_output=True, pe=None, dense=None):
    """Batched point-prompted prediction -> (low-res logits [B, M, 4g, 4g],
    iou preds [B, M]) (reference predictor.py:168-243 without host loops)."""
    sparse = embed_points(p_sam["prompt"], point_coords, point_labels, cfg, pad=True)
    if dense is None:
        dense = no_mask_dense(p_sam["prompt"], cfg, 1)[0]
    if pe is None:
        pe = dense_pe(p_sam["prompt"], cfg)
    return predict_masks(
        p_sam["decoder"], embedding, pe, sparse, cfg,
        dense_prompts=dense, multimask_output=multimask_output,
    )
