"""SAM image encoder (port of hybridgl_tpu/models/sam/image_encoder.py).

ViTDet-style: 16x16 patch embed + absolute position embedding, ``depth``
blocks of windowed attention except the global blocks, decomposed relative
position bias, and a two-conv neck to ``prompt_dim`` channels
(reference: segment_anything/modeling/image_encoder.py). Activations are
NHWC, as in the reference, and the encoder runs at the param dtype.

Attention routing follows the reference's ``_attention`` (:123-237):
windows of 8 <= size < 32 go to K1 (``flash_windowed_fused``), global
grids of size >= 32 to K2 (``flash_attention_fused``), smaller sizes to the
plain PyTorch version of the same math. ViT-H pads its 64x64 grid to 70x70,
so a windowed block runs 25 windows of S = 196.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.config import SamConfig

from ...kernels.flash_attention import (
    flash_attention_fused,
    flash_windowed_fused,
    reference_attention_rel_pos,
)

LN_EPS = 1e-6  # build_sam.py uses LayerNorm(eps=1e-6) throughout the encoder


def _ln(p, x, eps=LN_EPS):
    """LayerNorm over the last axis, computed in f32, returned in x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def layer_norm_2d(p, x, eps=LN_EPS):
    """Channel LayerNorm on NHWC maps (reference LayerNorm2d, common.py:27-43)."""
    return _ln(p, x, eps)


def get_rel_pos_table(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """R[q, k] = rel_pos[q - k + size - 1]; [size, size, head_dim]."""
    q = torch.arange(size, device=rel_pos.device)[:, None]
    k = torch.arange(size, device=rel_pos.device)[None, :]
    return rel_pos[q - k + (size - 1)]


def _attention(p_attn, x: torch.Tensor, num_heads: int, size: int) -> torch.Tensor:
    """Windowed/global attention over [B, size, size, D] tiles with rel-pos."""
    B = x.shape[0]
    S = size * size
    dt = x.dtype
    qkv = x.reshape(B, S, x.shape[-1]) @ p_attn["qkv_w"].to(dt) + p_attn["qkv_b"].to(dt)
    # the attention width is the projection's: num_heads heads of the block's
    # own, or the local heads of a tensor-parallel shard (parallel/encoder_tp.py)
    D = qkv.shape[-1] // 3
    hd = D // num_heads

    def heads(t):  # [B, S, D] -> [B*H, S, hd]
        return t.reshape(B, S, num_heads, hd).transpose(1, 2).reshape(B * num_heads, S, hd).contiguous()

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    # the two rank-G bias terms from the unscaled q, kept in f32:
    # rel_h[b, (qh, qw), kh] = q[b, qh, qw] . Rh[qh, kh], likewise rel_w
    if "rel_tab_h" in p_attn:  # built once by prepare_sam_params
        Rh, Rw = p_attn["rel_tab_h"], p_attn["rel_tab_w"]
    else:
        Rh = get_rel_pos_table(size, p_attn["rel_pos_h"].float())
        Rw = get_rel_pos_table(size, p_attn["rel_pos_w"].float())
    q6 = q.float().reshape(B * num_heads, size, size, hd)
    rel_h = torch.einsum("bhwc,hkc->bhwk", q6, Rh).reshape(B * num_heads, S, size)
    rel_w = torch.einsum("bhwc,wkc->bhwk", q6, Rw).reshape(B * num_heads, S, size)
    scale = hd**-0.5
    if 8 <= size < 32:
        attend = flash_windowed_fused
    elif size >= 32:
        attend = flash_attention_fused
    else:
        attend = reference_attention_rel_pos
    out = attend(q, k, v, rel_h.contiguous(), rel_w.contiguous(), size, scale)
    out = out.reshape(B, num_heads, S, hd).transpose(1, 2).reshape(B, S, D)
    out = out @ p_attn["proj_w"].to(dt) + p_attn["proj_b"].to(dt)
    return out.reshape(B, size, size, out.shape[-1])


def prepare_sam_params(sam_params, cfg: SamConfig):
    """A copy of the SAM params with what depends on the weights alone built
    once (the serving half of the reference's ``stack_encoder_runs``,
    image_encoder.py:304, without its stacking, a scan artefact): each encoder
    block's [size, size, head_dim] rel-pos tables in f32, and the decoder's
    prepared products (``decoder.py:prepare_decoder_params``). Idempotent; the
    raw tree keeps working."""
    out = dict(sam_params)
    if "encoder" in out:
        enc = dict(out["encoder"])
        blocks = []
        for i, bp in enumerate(enc["blocks"]):
            size = cfg.embed_grid if i in cfg.encoder_global_idx else cfg.window_size
            attn = dict(bp["attn"])
            if "rel_tab_h" not in attn:
                attn["rel_tab_h"] = get_rel_pos_table(size, attn["rel_pos_h"].float())
                attn["rel_tab_w"] = get_rel_pos_table(size, attn["rel_pos_w"].float())
            blocks.append(dict(bp, attn=attn))
        enc["blocks"] = blocks
        out["encoder"] = enc
    if "decoder" in out:
        from .decoder import prepare_decoder_params

        out["decoder"] = prepare_decoder_params(out["decoder"], cfg)
    return out


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> [B*nW, win, win, C] with zero padding (image_encoder.py:243-264)."""
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(wins: torch.Tensor, window: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    C = wins.shape[-1]
    B = wins.shape[0] // ((Hp // window) * (Wp // window))
    x = wins.reshape(B, Hp // window, Wp // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def _mlp(p, x):
    dt = x.dtype
    h = x @ p["mlp_fc"]["w"].to(dt) + p["mlp_fc"]["b"].to(dt)
    h = F.gelu(h, approximate="none")
    return h @ p["mlp_proj"]["w"].to(dt) + p["mlp_proj"]["b"].to(dt)


def encoder_block(p, x: torch.Tensor, cfg: SamConfig, window: int) -> torch.Tensor:
    """One ViTDet block; window == 0 means global attention (image_encoder.py:166-182)."""
    shortcut = x
    x = _ln(p["ln_1"], x)
    if window > 0:
        H, W = x.shape[1], x.shape[2]
        wins, pad_hw = window_partition(x, window)
        wins = _attention(p["attn"], wins, cfg.encoder_heads, window)
        x = window_unpartition(wins, window, pad_hw, (H, W))
    else:
        x = _attention(p["attn"], x, cfg.encoder_heads, x.shape[1])
    x = shortcut + x
    return x + _mlp(p, _ln(p["ln_2"], x))


def _conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """NHWC convolution with an HWIO kernel (the reference's layouts)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def embed_patches(p, images: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """Patchify + abs pos embed at the param dtype. The stride-16 16x16 conv
    is a matmul over each patch's (kh, kw, cin) pixels."""
    w = p["patch_embed"]["w"]
    dt = w.dtype
    N, H, W, _ = images.shape
    ps = cfg.patch_size
    g_h, g_w = H // ps, W // ps
    patches = images.to(dt).reshape(N, g_h, ps, g_w, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = patches.reshape(N, g_h, g_w, ps * ps * 3) @ w.reshape(ps * ps * 3, -1)
    x = x + p["patch_embed"]["b"].to(dt)
    return x + p["pos_embed"].to(dt)


def neck(p, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv -> LN2d -> 3x3 conv -> LN2d (image_encoder.py:88-104)."""
    dt = x.dtype
    w1 = p["neck"]["conv1_w"].to(dt)
    x = x @ w1.reshape(w1.shape[2], w1.shape[3])
    x = layer_norm_2d(p["neck"]["ln1"], x)
    x = _conv_nhwc(x, p["neck"]["conv2_w"].to(dt), stride=1, padding=1)
    return layer_norm_2d(p["neck"]["ln2"], x)


def encode_image(p, images: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """images: [N, img, img, 3] preprocessed -> [N, g, g, prompt_dim] at the
    param dtype (bf16 params select bf16 serving, as in the reference)."""
    x = embed_patches(p, images, cfg)
    for i, bp in enumerate(p["blocks"]):
        window = 0 if i in cfg.encoder_global_idx else cfg.window_size
        x = encoder_block(bp, x, cfg, window)
    return neck(p, x)
