"""GEM dense relevance via self-self attention (port of hybridgl_tpu/models/gem/gem.py).

The last ``depth`` ViT blocks run a parallel "gem" stream whose attention is
the qq/kk/vv self-self ensemble (Bousselham et al., CVPR 2024): for t in
{q, k, v}, attn_t = softmax(temp * norm(t) norm(t)^T), applied to v; the
ensemble mean goes through the block's output projection into the gem
stream (residual, no MLP). Inputs are 448^2 with the 224-pretrained
positional embedding bilinearly interpolated. The 785-token attention is
plain PyTorch (the reference has no kernel for it).
"""

from __future__ import annotations

import torch

from ...core.config import ClipConfig, GemConfig
from ...core.dtypes import score_dtype, softmax_scores
from ...kernels.resize import resize_bilinear
from ..clip.layers import layer_norm, linear, quick_gelu

GEM_NORM_MEAN = (0.48145466, 0.4578275, 0.40821073)
GEM_NORM_STD = (0.26862954, 0.26130258, 0.27577711)


def interpolate_pos_embedding(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """[1+g*g, D] -> [1+G*G, D] bilinear over the spatial grid."""
    cls, patches = pos[:1], pos[1:]
    g = int(round(patches.shape[0] ** 0.5))
    up = resize_bilinear(patches.reshape(g, g, -1), (new_grid, new_grid))
    return torch.cat([cls, up.reshape(new_grid * new_grid, -1)], dim=0)


def _qkv(p_attn, x, num_heads):
    N, L, D = x.shape
    hd = D // num_heads
    qkv = x @ p_attn["in_proj_w"].to(x.dtype) + p_attn["in_proj_b"].to(x.dtype)
    return (t.reshape(N, L, num_heads, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))


def _merge_heads(t):
    N, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(N, L, H * hd)


def _l2norm(t, eps=1e-6):
    # the squares round in t's dtype before the sum, as in the reference's jnp.linalg.norm
    return t / torch.clamp(torch.sqrt((t * t).sum(dim=-1, keepdim=True)), min=eps)


def _scores(a, b, scale, sdt):
    """scale * a b^T with f32 sums, stored in the score dtype (core/dtypes.py)."""
    return (scale * torch.matmul(a.float(), b.float().transpose(-1, -2))).to(sdt)


def self_self_attention(q, k, v, temp: float, iters: int):
    """qq/kk/vv ensemble; returns [N, H, L, hd]."""
    sdt = score_dtype(q.dtype)
    outs = []
    for t in (q, k, v):
        tn = _l2norm(t)
        attn = None
        for _ in range(max(iters, 1)):
            attn = softmax_scores(_scores(tn, tn, temp, sdt)).to(t.dtype)
            tn = _l2norm(torch.matmul(attn, tn))
        outs.append(torch.matmul(attn, v))
    return (outs[0] + outs[1] + outs[2]) / 3.0


def _std_attention(q, k, v, scale):
    attn = softmax_scores(_scores(q, k, scale, score_dtype(q.dtype))).to(v.dtype)
    return torch.matmul(attn, v)


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
    x_gem = None
    for i, blk in enumerate(p_visual["blocks"]):
        if i >= gem_start and x_gem is None:
            x_gem = x
        q, k, v = _qkv(blk["attn"], layer_norm(blk["ln_1"], x), H)
        out_w, out_b = blk["attn"]["out_w"].to(dt), blk["attn"]["out_b"].to(dt)
        if i >= gem_start:
            ss = _merge_heads(self_self_attention(q, k, v, temp, gem_cfg.ss_attn_iters))
            x_gem = x_gem + (ss @ out_w + out_b)  # gem stream: attention only, no MLP
        o = _merge_heads(_std_attention(q * scale, k, v, 1.0)) @ out_w + out_b
        x = x + o
        h = quick_gelu(linear(blk["mlp_fc"], layer_norm(blk["ln_2"], x)))
        x = x + linear(blk["mlp_proj"], h)

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
    mean = torch.tensor(GEM_NORM_MEAN, device=x.device)
    std = torch.tensor(GEM_NORM_STD, device=x.device)
    return (x - mean) / std
