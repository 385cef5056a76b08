"""SAM prompt encoder (port of hybridgl_tpu/models/sam/prompt_encoder.py).

Random-Fourier positional encoding over normalized coordinates, learned
point and box-corner embeddings, and the dense no-mask embedding
(reference: segment_anything/modeling/prompt_encoder.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.config import SamConfig


def _pe_encode(p, coords01: torch.Tensor) -> torch.Tensor:
    """coords in [0,1]^2, [..., 2] -> [..., prompt_dim] (prompt_encoder.py:185-192)."""
    coords = 2.0 * coords01 - 1.0
    coords = coords @ p["pe_gaussian"].to(coords.dtype)
    coords = 2.0 * np.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def dense_pe(p, cfg: SamConfig) -> torch.Tensor:
    """Positional encoding grid [g, g, prompt_dim] (prompt_encoder.py:194-205)."""
    g = cfg.embed_grid
    dev = p["pe_gaussian"].device
    y = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    x = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    grid = torch.stack([x[None, :].expand(g, g), y[:, None].expand(g, g)], dim=-1)
    return _pe_encode(p, grid)


def embed_points(p, coords: torch.Tensor, labels: torch.Tensor, cfg: SamConfig, pad: bool = True):
    """coords [B, N, 2] in 1024-frame pixels, labels [B, N] in {-1, 0, 1} ->
    sparse embeddings [B, N(+1), prompt_dim]; ``pad`` appends the (0, 0)/-1
    padding point (prompt_encoder.py:80-91)."""
    if pad:
        B = coords.shape[0]
        coords = torch.cat([coords, torch.zeros((B, 1, 2), dtype=coords.dtype, device=coords.device)], 1)
        labels = torch.cat([labels, -torch.ones((B, 1), dtype=labels.dtype, device=labels.device)], 1)
    coords = (coords + 0.5) / cfg.img_size
    emb = _pe_encode(p, coords)
    lab = labels[..., None]
    pts = p["point_embeddings"].to(emb.dtype)
    emb = torch.where(lab == -1, p["not_a_point_embed"].to(emb.dtype), emb)
    emb = emb + torch.where(lab == 0, pts[0], 0.0)
    emb = emb + torch.where(lab == 1, pts[1], 0.0)
    return emb


def embed_boxes(p, boxes: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """boxes [B, 4] XYXY in 1024-frame pixels -> [B, 2, prompt_dim] corner
    embeddings (prompt_encoder.py:93-100)."""
    corners = (boxes.reshape(-1, 2, 2) + 0.5) / cfg.img_size
    emb = _pe_encode(p, corners)
    return emb + p["point_embeddings"][2:4].to(emb.dtype)


def no_mask_dense(p, cfg: SamConfig, batch: int) -> torch.Tensor:
    """No-mask dense embedding broadcast over the grid, NHWC [batch, g, g, C]."""
    g = cfg.embed_grid
    return p["no_mask_embed"].reshape(1, 1, 1, -1).expand(batch, g, g, cfg.prompt_dim)
