"""SAM two-way transformer + mask decoder (port of hybridgl_tpu/models/sam/decoder.py).

Semantics of the reference (segment_anything/modeling/transformer.py and
mask_decoder.py): IoU token + 4 mask tokens, two {token self-attention,
token->image cross-attention, MLP, image->token cross-attention} layers with
attention downsample rate 2, a final token->image attention, 4x
transposed-conv upscaling and per-token hypernetwork MLPs.

This is the reference's plain path (what it runs with
``HYBRIDGL_FUSED_PASS/I2T/T2I/UPSCALE=0``): the shared-image layer 0
(decoder.py:741-797), the later layers (:799-864) and the upscale +
hypernetwork tail (:1013-1030). The reference's side-switched attention
forms, prepared weight products and blocked layouts are TPU work savers,
not semantics, and are left out: attention here is the standard projected
form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hybridgl_tpu.core.config import SamConfig

from .image_encoder import layer_norm_2d

LN_EPS = 1e-5  # decoder transformer norms are default torch LayerNorm


def _ln(p, x, eps=LN_EPS):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _lin(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _sdpa(q, k, v, num_heads: int):
    """Multi-head attention core on projected [..., L, D] tensors whose
    leading dims broadcast; f32 scores and softmax."""
    D = q.shape[-1]
    hd = D // num_heads

    def heads(t):
        return t.reshape(t.shape[:-1] + (num_heads, hd)).transpose(-3, -2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / (hd**0.5)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    out = torch.matmul(attn, vh.to(q.dtype))
    return out.transpose(-3, -2).reshape(out.shape[:-3] + (out.shape[-2], D))


def _attn(p, q, k, v, num_heads: int):
    """Projected multi-head attention (reference transformer.py:185-240)."""
    out = _sdpa(_lin(p["q"], q), _lin(p["k"], k), _lin(p["v"], v), num_heads)
    return _lin(p["out"], out)


def _mlp_relu(p_fc, p_proj, x):
    return _lin(p_proj, torch.relu(_lin(p_fc, x)))


def two_way_transformer(p, image_embedding, image_pe, point_embedding, cfg: SamConfig, shared_image: bool = False):
    """Returns (queries [B, T, C], keys [B, g*g, C]) (transformer.py:62-106).

    With ``shared_image`` the image side enters un-batched ([g*g, C]): in
    layer 0 it is identical for every prompt, so its projections run once
    and the [B, g*g, C] image stream first appears as layer 0's
    image->token output. Same math as the batched path."""
    h = cfg.decoder_heads
    queries = point_embedding
    if shared_image:
        layer0 = p["layers"][0]
        # layer 0 REPLACES queries with the self-attention output — no
        # residual (reference transformer.py:155-156, skip_first_layer_pe)
        queries = _attn(layer0["self_attn"], queries, queries, queries, h)
        queries = _ln(layer0["norm1"], queries)

        q = queries + point_embedding
        k_img = image_embedding + image_pe  # [g*g, C], shared
        queries = queries + _attn(layer0["cross_t2i"], q, k_img, image_embedding, h)
        queries = _ln(layer0["norm2"], queries)
        queries = queries + _mlp_relu(layer0["mlp_fc"], layer0["mlp_proj"], queries)
        queries = _ln(layer0["norm3"], queries)

        # image -> token: the shared image queries broadcast against the
        # per-prompt token keys/values
        q = queries + point_embedding
        pi = layer0["cross_i2t"]
        out = _sdpa(_lin(pi["q"], k_img)[None], _lin(pi["k"], q), _lin(pi["v"], queries), h)
        keys = image_embedding[None] + _lin(pi["out"], out)
        keys = _ln(layer0["norm4"], keys)
        image_pe = image_pe[None]
        layers, first = p["layers"][1:], 1
    else:
        keys = image_embedding
        layers, first = p["layers"], 0

    for i, layer in enumerate(layers, first):
        if i == 0:
            queries = _attn(layer["self_attn"], queries, queries, queries, h)
        else:
            q = queries + point_embedding
            queries = queries + _attn(layer["self_attn"], q, q, queries, h)
        queries = _ln(layer["norm1"], queries)

        q = queries + point_embedding
        kpe = keys + image_pe
        queries = queries + _attn(layer["cross_t2i"], q, kpe, keys, h)
        queries = _ln(layer["norm2"], queries)
        queries = queries + _mlp_relu(layer["mlp_fc"], layer["mlp_proj"], queries)
        queries = _ln(layer["norm3"], queries)

        q = queries + point_embedding
        kpe = keys + image_pe
        keys = keys + _attn(layer["cross_i2t"], kpe, q, queries, h)
        keys = _ln(layer["norm4"], keys)

    q = queries + point_embedding
    kpe = keys + image_pe
    queries = queries + _attn(p["final_attn"], q, kpe, keys, h)
    queries = _ln(p["norm_final"], queries)
    return queries, keys


def _mlp_stack(layers, x):
    for i, p in enumerate(layers):
        x = _lin(p, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def predict_masks(p_dec, image_embedding, image_pe, sparse_prompts, cfg: SamConfig, dense_prompts=None, multimask_output: bool = True):
    """All-prompts-at-once mask prediction (mask_decoder.py:94-149).

    image_embedding, image_pe: [g, g, C] NHWC; sparse_prompts [B, T, C];
    dense_prompts None, [g, g, C] (shared) or [B, g, g, C]. Returns (mask
    logits [B, M, 4g, 4g] f32, iou predictions [B, M] f32), M = 3 with
    multimask_output else 1. Runs at the param dtype."""
    B = sparse_prompts.shape[0]
    g = cfg.embed_grid
    C = cfg.prompt_dim
    nmt = cfg.num_mask_tokens
    dt = p_dec["transformer"]["final_attn"]["q"]["w"].dtype
    sparse_prompts = sparse_prompts.to(dt)

    output_tokens = torch.cat([p_dec["iou_token"], p_dec["mask_tokens"]], dim=0).to(dt)
    tokens = torch.cat([output_tokens[None].expand(B, nmt + 1, C), sparse_prompts], dim=1)

    if dense_prompts is None or dense_prompts.ndim == 3:
        src = image_embedding if dense_prompts is None else image_embedding + dense_prompts
        src = src.reshape(g * g, C).to(dt)
        pe = image_pe.reshape(g * g, C).to(dt)
        hs, src = two_way_transformer(p_dec["transformer"], src, pe, tokens, cfg, shared_image=True)
    else:
        src = (image_embedding[None] + dense_prompts).reshape(B, g * g, C).to(dt)
        pe = image_pe.reshape(1, g * g, C).to(dt)
        hs, src = two_way_transformer(p_dec["transformer"], src, pe, tokens, cfg)
    iou_token_out = hs[:, 0, :]
    mask_tokens_out = hs[:, 1 : 1 + nmt, :]

    hyper = torch.stack(
        [_mlp_stack(p_dec["hyper_mlps"][i], mask_tokens_out[:, i, :]) for i in range(nmt)], dim=1
    )  # [B, nmt, C/8]
    # the caller keeps tokens [1:] (multimask) or [:1]: select the
    # hypernetwork rows before the contraction (decoder.py:974-979)
    sel = slice(1, None) if multimask_output else slice(0, 1)
    hyper = hyper[:, sel]
    n_sel = hyper.shape[1]

    # upscale 4x (mask_decoder.py:53-59): both transposed convs have kernel
    # == stride == 2, so each is a per-pixel matmul onto a 2x2 sub-grid
    u1, u2 = p_dec["upscale"]["deconv1"], p_dec["upscale"]["deconv2"]
    c4, c8 = u1["w"].shape[-1], u2["w"].shape[-1]
    w1 = u1["w"].permute(2, 0, 1, 3).reshape(C, 4 * c4).to(dt)  # [C, (i j c4)]
    w2 = u2["w"].permute(2, 0, 1, 3).reshape(c4, 4 * c8).to(dt)  # [c4, (e f c8)]
    x = src.reshape(B, g, g, C) @ w1
    x = x.reshape(B, g, g, 2, 2, c4) + u1["b"].to(dt)
    x = layer_norm_2d(p_dec["upscale"]["ln"], x)
    x = F.gelu(x, approximate="none")
    x = (x @ w2).reshape(B, g, g, 2, 2, 2, 2, c8) + u2["b"].to(dt)
    x = F.gelu(x, approximate="none")  # [b, h, w, i, j, e, f, c]
    # rows are (h, i, e) -> 4h+2i+e, cols (w, j, f) -> 4w+2j+f
    masks = torch.einsum("bmc,bhwijefc->bmhiewjf", hyper.float(), x.float())
    masks = masks.reshape(B, n_sel, 4 * g, 4 * g)
    iou_pred = _mlp_stack(p_dec["iou_head"], iou_token_out).float()
    return masks, iou_pred[:, sel]
