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

The glue between a block's four matrix products and its attention kernel
runs as the fused operators of ``kernels/sam_glue.py``: each LayerNorm is
written by the kernel that writes the residual it normalises, straight into
the layout of windows of the block that reads it, and each bias add, head
split and merge, the rel-pos terms and the GELU ride on the kernel that
reads the product. On a CPU tensor they run their plain versions, the
sequence of PyTorch operations this module ran before, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.config import SamConfig

from ...kernels import sam_glue
from ...kernels.flash_attention import (
    flash_attention_fused,
    flash_windowed_fused,
    reference_attention_rel_pos,
)
from ...kernels.sam_glue import LN_EPS


def _ln(p, x, eps=LN_EPS):
    """LayerNorm over the last axis, computed in f32, returned in x's dtype."""
    return sam_glue.reference_layer_norm(x, p["scale"], p["bias"], 0, eps)


def layer_norm_2d(p, x, eps=LN_EPS):
    """Channel LayerNorm on NHWC maps (reference LayerNorm2d, common.py:27-43)."""
    return _ln(p, x, eps)


def get_rel_pos_table(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """R[q, k] = rel_pos[q - k + size - 1]; [size, size, head_dim]."""
    q = torch.arange(size, device=rel_pos.device)[:, None]
    k = torch.arange(size, device=rel_pos.device)[None, :]
    return rel_pos[q - k + (size - 1)]


def _rel_tables(p_attn, size: int):
    """The block's [size, size, head_dim] f32 rel-pos tables (built once by prepare_sam_params)."""
    if "rel_tab_h" in p_attn:
        return p_attn["rel_tab_h"], p_attn["rel_tab_w"]
    return (get_rel_pos_table(size, p_attn["rel_pos_h"].float()), get_rel_pos_table(size, p_attn["rel_pos_w"].float()))


def _attention_product(p_attn, x: torch.Tensor, num_heads: int, size: int) -> torch.Tensor:
    """Windowed/global attention over [B, size, size, D] tiles with rel-pos,
    up to the output projection's product without its bias: [B, S, D]."""
    B = x.shape[0]
    dt = x.dtype
    y = x.reshape(B, size * size, x.shape[-1]) @ p_attn["qkv_w"].to(dt)
    # the attention width is the projection's: num_heads heads of the block's
    # own, or the local heads of a tensor-parallel shard (parallel/encoder_tp.py)
    q, k, v, rel_h, rel_w = sam_glue.qkv_heads(y, p_attn["qkv_b"].to(dt), *_rel_tables(p_attn, size), num_heads)
    scale = q.shape[-1] ** -0.5
    if 8 <= size < 32:
        attend = flash_windowed_fused
    elif size >= 32:
        attend = flash_attention_fused
    else:
        attend = reference_attention_rel_pos
    out = attend(q, k, v, rel_h, rel_w, size, scale)
    return sam_glue.merge_heads(out, B) @ p_attn["proj_w"].to(dt)


def _attention(p_attn, x: torch.Tensor, num_heads: int, size: int) -> torch.Tensor:
    """Windowed/global attention over [B, size, size, D] tiles with rel-pos."""
    out = _attention_product(p_attn, x, num_heads, size) + p_attn["proj_b"].to(x.dtype)
    return out.reshape(x.shape[0], size, size, out.shape[-1])


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


def _mlp(p, x):
    dt = x.dtype
    h = x @ p["mlp_fc"]["w"].to(dt) + p["mlp_fc"]["b"].to(dt)
    h = F.gelu(h, approximate="none")
    return h @ p["mlp_proj"]["w"].to(dt) + p["mlp_proj"]["b"].to(dt)


def encoder_block(p, x: torch.Tensor, ln_x: torch.Tensor, cfg: SamConfig, window: int, next_ln=None,
                  next_window: int = 0):
    """One ViTDet block (image_encoder.py:166-182); window == 0 means global
    attention. ``x`` is the residual stream [N, H, W, D] and ``ln_x`` its
    ln_1, in the layout of windows of ``window`` (the grid where 0). Returns
    the block's output and, given the next block's ln_1 params ``next_ln``,
    its LayerNorm in the layout of windows of ``next_window`` (else None)."""
    dt = x.dtype
    y = _attention_product(p["attn"], ln_x, cfg.encoder_heads, window or x.shape[1])
    x, h = sam_glue.residual_layer_norm(x, y, p["attn"]["proj_b"].to(dt), p["ln_2"]["scale"], p["ln_2"]["bias"],
                                        window, 0)
    h = sam_glue.bias_gelu(h @ p["mlp_fc"]["w"].to(dt), p["mlp_fc"]["b"].to(dt))
    y = h @ p["mlp_proj"]["w"].to(dt)
    if next_ln is None:
        return sam_glue.residual_add(x, y, p["mlp_proj"]["b"].to(dt)), None
    return sam_glue.residual_layer_norm(x, y, p["mlp_proj"]["b"].to(dt), next_ln["scale"], next_ln["bias"], 0,
                                        next_window)


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
    blocks = p["blocks"]
    windows = [0 if i in cfg.encoder_global_idx else cfg.window_size for i in range(len(blocks))]
    ln_x = sam_glue.layer_norm(x, blocks[0]["ln_1"]["scale"], blocks[0]["ln_1"]["bias"], windows[0])
    for i, bp in enumerate(blocks):
        nxt = i + 1 < len(blocks)
        x, ln_x = encoder_block(bp, x, ln_x, cfg, windows[i], blocks[i + 1]["ln_1"] if nxt else None,
                                windows[i + 1] if nxt else 0)
    return neck(p, x)
