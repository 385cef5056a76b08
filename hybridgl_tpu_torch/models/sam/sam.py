"""SAM composite: preprocessing + prompted prediction (port of hybridgl_tpu/models/sam/sam.py)."""

from __future__ import annotations

import torch

from ...core.config import SamConfig
from ...kernels.resize import resize_bilinear, valid_mask

from .decoder import predict_masks
from .image_encoder import encode_image
from .prompt_encoder import dense_pe, embed_points, no_mask_dense


def get_preprocess_shape(h: int, w: int, long_side: int) -> tuple[int, int]:
    """Longest-side resize target (reference utils/transforms.py:93-102)."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _pixel_stats(cfg: SamConfig, device):
    """The normalisation's mean and std, [3] f32 each, made on the device
    from fills (no host buffer, so a captured stage keeps nothing of the host)."""
    return tuple(torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in vals])
                 for vals in (cfg.pixel_mean, cfg.pixel_std))


def preprocess(image: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """[H <= S, W <= S, 3] uint8 or float, already longest-side resized ->
    normalized, then zero-padded to [S, S, 3] (reference sam.py:164-174: the
    pad is 0 in normalized space)."""
    mean, std = _pixel_stats(cfg, image.device)
    x = (image.float() - mean) / std
    return torch.nn.functional.pad(x, (0, 0, 0, cfg.img_size - x.shape[1], 0, cfg.img_size - x.shape[0]))


def preprocess_padded(image_1024: torch.Tensor, valid_hw, cfg: SamConfig) -> torch.Tensor:
    """Normalize an already padded [S, S, 3] frame and zero the pad
    (reference sam.py:164-174: the pad is 0 in normalized space). The valid
    extent ``valid_hw`` is numbers or 0-d tensors (the proposal stage's)."""
    mean, std = _pixel_stats(cfg, image_1024.device)
    x = (image_1024.float() - mean) / std
    valid = valid_mask((cfg.img_size, cfg.img_size), valid_hw, image_1024.device)
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


def upscale_logits_to_input_frame(low_res: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """[..., 4g, 4g] logits -> [..., S, S] bilinear (the first stage of the
    reference's postprocess_masks, sam.py:154-159)."""
    return resize_bilinear(low_res, (cfg.img_size, cfg.img_size), axis=low_res.ndim - 2)
