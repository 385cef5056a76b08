"""GEM dense relevance via self-self attention (port of hybridgl_tpu/models/gem/gem.py).

The last ``depth`` ViT blocks run a parallel "gem" stream whose attention is
the qq/kk/vv self-self ensemble (Bousselham et al., CVPR 2024): for t in
{q, k, v}, attn_t = softmax(temp * norm(t) norm(t)^T), applied to v; the
ensemble mean goes through the block's output projection into the gem
stream (residual, no MLP). Inputs are 448^2 with the 224-pretrained
positional embedding bilinearly interpolated. Each block's attention, the
trunk's and in the last ``depth`` blocks the ensemble beside it, is one call
of ``kernels/gem_attention.py`` (a hand-written kernel on the card, at 785
tokens on ViT-B/16 and 1,025 on ViT-L/14@336; the plain version, moved there
unchanged, on the CPU); the head split is the fused glue's ``qkv_heads``.
"""

from __future__ import annotations

import functools

import torch

from ...core.config import ClipConfig, GemConfig
from ...kernels import clip_glue
from ...kernels.gem_attention import _l2norm, gem_attention
from ...kernels.resize import resize_bilinear
from ...utils.transfer import upload
from ..clip.layers import layer_norm, mlp_residual, residual_layer_norm

GEM_NORM_MEAN = (0.48145466, 0.4578275, 0.40821073)
GEM_NORM_STD = (0.26862954, 0.26130258, 0.27577711)


def interpolate_pos_embedding(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """[1+g*g, D] -> [1+G*G, D] bilinear over the spatial grid."""
    cls, patches = pos[:1], pos[1:]
    g = int(round(patches.shape[0] ** 0.5))
    up = resize_bilinear(patches.reshape(g, g, -1), (new_grid, new_grid))
    return torch.cat([cls, up.reshape(new_grid * new_grid, -1)], dim=0)


def gem_image_features(p_visual, images: torch.Tensor, clip_cfg: ClipConfig, gem_cfg: GemConfig):
    """images [N, S, S, 3] normalized -> (gem patch feats [N, G*G, embed] f32,
    CLS feats [N, embed] f32, G)."""
    S = images.shape[1]
    ps = clip_cfg.patch_size
    G = S // ps
    H = clip_cfg.vision_heads
    hd = clip_cfg.vision_width // H
    temp = gem_cfg.ss_attn_temp if gem_cfg.ss_attn_temp is not None else hd**-0.5
    scale = hd**-0.5
    w = p_visual["conv1"]
    dt = w.dtype
    N = images.shape[0]
    patches = images.to(dt).reshape(N, G, ps, G, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = patches.reshape(N, G * G, ps * ps * 3) @ w.reshape(ps * ps * 3, -1)
    cls = p_visual["class_embedding"].to(dt).expand(N, 1, clip_cfg.vision_width)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embedding(p_visual["positional_embedding"].to(dt), G)
    x = layer_norm(p_visual["ln_pre"], x)

    gem_start = clip_cfg.vision_layers - gem_cfg.depth
    blocks = p_visual["blocks"]
    x_gem = a = None  # a: the block's ln_1(x), from the kernel that wrote x
    for i, blk in enumerate(blocks):
        if i >= gem_start and x_gem is None:
            x_gem = x
        p = blk["attn"]
        q, k, v = clip_glue.qkv_heads((layer_norm(blk["ln_1"], x) if a is None else a) @ p["in_proj_w"].to(dt),
                                      p["in_proj_b"].to(dt), H)
        out_w, out_b = p["out_w"].to(dt), p["out_b"].to(dt)
        # [1 or 2, N, L, D]: the trunk's context, then in the last depth blocks the ensemble's
        o = gem_attention(q, k, v, N, scale, temp, gem_cfg.ss_attn_iters, i >= gem_start) @ out_w
        if i >= gem_start:
            x_gem, _ = residual_layer_norm(x_gem, o[1], out_b, None)  # gem stream: attention only, no MLP
        x, a = residual_layer_norm(x, o[0], out_b, blk["ln_2"])
        x, a = mlp_residual(blk, x, a, blocks[i + 1]["ln_1"] if i + 1 < len(blocks) else None)

    proj = p_visual["proj"].to(dt)
    gem_feats = layer_norm(p_visual["ln_post"], x_gem) @ proj
    cls_feats = layer_norm(p_visual["ln_post"], x[:, :1])[:, 0] @ proj
    return gem_feats[:, 1:].float(), cls_feats.float(), G


def gem_heatmap(p_clip, image: torch.Tensor, text_features: torch.Tensor, clip_cfg: ClipConfig,
                gem_cfg: GemConfig) -> torch.Tensor:
    """Per-phrase relevance heatmaps [T, S, S] of a normalized [S, S, 3]
    image and [T, embed] text features, bilinearly upsampled from the patch
    grid (gem-torch's output frame)."""
    patch_feats, _, G = gem_image_features(p_clip["visual"], image[None], clip_cfg, gem_cfg)
    rel = (_l2norm(patch_feats[0]) @ _l2norm(text_features).T).T.reshape(-1, G, G)  # [T, G, G]
    S = image.shape[0]
    return resize_bilinear(rel, (S, S), axis=1)


def gem_preprocess(image_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [H, W, 3] -> normalized [size, size, 3] (squash resize + OpenAI
    CLIP normalization, gem.get_gem_img_transform)."""
    x = image_u8.float()
    if tuple(x.shape[:2]) != (size, size):
        x = resize_bilinear(x, (size, size))
    x = x / 255.0
    mean, std = norm_constants(x.device)
    return (x - mean) / std


@functools.lru_cache(maxsize=None)
def norm_constants(device: torch.device):
    """(OpenAI CLIP mean, std) on ``device``, made once a device (not uploaded at every image)."""
    return upload(GEM_NORM_MEAN, device, torch.float32), upload(GEM_NORM_STD, device, torch.float32)
