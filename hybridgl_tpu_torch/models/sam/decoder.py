"""SAM two-way transformer + mask decoder (port of hybridgl_tpu/models/sam/decoder.py).

Semantics of the reference (segment_anything/modeling/transformer.py and
mask_decoder.py): IoU token + 4 mask tokens, two {token self-attention,
token->image cross-attention, MLP, image->token cross-attention} layers with
attention downsample rate 2, a final token->image attention, 4x
transposed-conv upscaling and per-token hypernetwork MLPs.

Routes, chosen by the reference's four switches (default ON; ``=0`` opts
out), exactly as decoder.py:737-864, 981 choose them:

  * ``HYBRIDGL_FUSED_PASS``: the shared-image transformer runs as two fused
    layer passes (K3, ``kernels/decoder_pass.py``), each an i2t + norm4
    sweep that also accumulates the next t2i (_two_way_fused_passes);
  * ``HYBRIDGL_FUSED_I2T``: every image->token update + norm4 is K7
    (``kernels/decoder_attn.py``);
  * ``HYBRIDGL_FUSED_T2I``: every token->image attention on the per-prompt
    stream is K8 (``kernels/decoder_attn_t2i.py``);
  * ``HYBRIDGL_FUSED_UPSCALE``: the upscale + hypernetwork tail is K4
    (``kernels/upscale_hyper.py``).

The kernels take the reference's side-switched operands: the image-side
projections are folded onto the ~7 prompt tokens (_i2t_prep_generic,
_i2t_prep_shared_q, _t2i_qw), so the [B, g*g, C] image stream is only read
by the kernels. Those token-side operand functions are tiny einsums in plain torch,
as in the reference. With a switch off, its stage runs the standard
projected attention form (or the plain upscale chain).

:func:`prepare_decoder_params` hoists what depends on the weights alone out
of the per-chunk decode (the reference's serving-time preparation,
decoder.py:332): the per-head score and readout products of every
token->image and image->token site, the hypernetwork MLPs stacked per depth,
the output-token concat, and, in the layouts the port's kernels take, the
per-pixel deconv matrices and the f32 bias and LayerNorm vectors of K3, K4,
K7 and K8 (the reference's kron-expanded, group-centred upscale weights are
TPU layout and have no counterpart). ``two_way_transformer`` and
``predict_masks`` take the prepared products where the tree has them; the raw
tree keeps working and gives the same results within rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.config import SamConfig
from ...utils.env import env_flag

from ...kernels.decoder_attn import i2t_ln_update
from ...kernels.decoder_attn_t2i import t2i_ctx
from ...kernels.decoder_pass import i2t_ln_then_t2i
from ...kernels.upscale_hyper import upscale_hyper
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


def use_fused_pass() -> bool:
    """Fused layer passes (K3); opt out with $HYBRIDGL_FUSED_PASS=0."""
    return env_flag("HYBRIDGL_FUSED_PASS", default=True)


def use_fused_i2t() -> bool:
    """Fused image->token update + norm4 (K7); opt out with $HYBRIDGL_FUSED_I2T=0."""
    return env_flag("HYBRIDGL_FUSED_I2T", default=True)


def use_fused_t2i() -> bool:
    """Flash token->image attention (K8); opt out with $HYBRIDGL_FUSED_T2I=0."""
    return env_flag("HYBRIDGL_FUSED_T2I", default=True)


def use_fused_upscale() -> bool:
    """Fused upscale + hypernetwork tail (K4); opt out with $HYBRIDGL_FUSED_UPSCALE=0."""
    return env_flag("HYBRIDGL_FUSED_UPSCALE", default=True)


def _tp_for(T: int) -> int:
    """Padded tokens per head group (>= T, a power of two, at least 8)."""
    tp = 8
    while tp < T:
        tp *= 2
    return tp


def _heads_w(p_lin, num_heads: int):
    """Projection weight/bias in the per-head view: [C, heads, hd], [heads, hd]."""
    C, D = p_lin["w"].shape
    return p_lin["w"].reshape(C, num_heads, D // num_heads), p_lin["b"].reshape(num_heads, D // num_heads)


def _prep_t2i(p, num_heads: int):
    """Token->image site (reference decoder.py:156): score weights
    A = W_q W_k^T and bias a = b_q W_k^T (scale folded; b_k cancels in the
    softmax), readout wvo = W_v W_out and const = b_v W_out + b_out."""
    wq, bq = _heads_w(p["q"], num_heads)
    wk, _ = _heads_w(p["k"], num_heads)
    scale = wq.shape[-1] ** -0.5
    A = torch.einsum("chd,ehd->hce", wq.float(), wk.float()) * scale
    a = torch.einsum("hd,ehd->he", bq.float(), wk.float()) * scale
    wv, bv = _heads_w(p["v"], num_heads)
    wo = p["out"]["w"].reshape(num_heads, wq.shape[-1], -1).float()
    wvo = torch.einsum("chd,hde->hce", wv.float(), wo)
    const = torch.einsum("hd,hde->e", bv.float(), wo) + p["out"]["b"].float()
    dt = p["q"]["w"].dtype
    return {
        "score_w": A.permute(1, 0, 2).reshape(A.shape[1], -1).to(dt),  # [C, h*C]
        "score_b": a.reshape(-1),
        "wvo_flat": wvo.reshape(-1, wvo.shape[-1]).to(dt),  # [h*C, C]
        "const": const,
    }


def _t2i_qw(p, q_tok, num_heads: int, prep=None):
    """The t2i score weights in the kernel layout, QW [B, C, heads*tp] f32
    (zero on the padding columns), plus the epilogue's (wvo, const, T, tp).
    ``prep``: the site's prepared products (:func:`prepare_decoder_params`)."""
    if prep is None:
        prep = _prep_t2i(p, num_heads)
    B, T = q_tok.shape[:2]
    sw = prep["score_w"]
    sw32 = prep["score_w_f32"] if "score_w_f32" in prep else sw.float()
    qw = torch.matmul(q_tok.to(sw.dtype).float(), sw32) + prep["score_b"]
    qw = qw.reshape(B, T, num_heads, -1).permute(0, 2, 1, 3)  # [B, h, T, C]
    tp = _tp_for(T)
    qw = F.pad(qw, (0, 0, 0, tp - T))
    QW = qw.permute(0, 3, 1, 2).reshape(B, qw.shape[-1], num_heads * tp)
    return QW, prep["wvo_flat"], prep["const"], T, tp


def _t2i_epilogue(ctx, wvo_flat, const, T: int, tp: int, num_heads: int, dt):
    """ctx [B, heads*tp, C] f32 -> the attention output [B, T, C]."""
    B, _, C = ctx.shape
    ctx = ctx.reshape(B, num_heads, tp, C)[:, :, :T].permute(0, 2, 1, 3).to(dt).reshape(B, T, num_heads * C)
    return ctx @ wvo_flat.to(dt) + const.to(dt)


def _t2i_fused(p, q_tok, keys, pe, num_heads: int, prep=None):
    """Token->image attention through K8 (reference decoder.py:534)."""
    QW, wvo, const, T, tp = _t2i_qw(p, q_tok, num_heads, prep=prep)
    return _t2i_epilogue(t2i_ctx(keys, pe, QW), wvo, const, T, tp, num_heads, q_tok.dtype)


def _i2t_prep_generic(p, k_tok, v_tok, num_heads: int, tp: int):
    """(w [B, C, GT], off [B, GT], vo [B, GT, C], const [C]) f32 for the
    image->token site whose score side is the unprojected kpe: the query
    projection folded onto the token keys, scale folded in, the token axis
    padded to tp per head with off = -1e30 (reference decoder.py:547)."""
    kh, vh = _lin(p["k"], k_tok), _lin(p["v"], v_tok)
    B, T, D = kh.shape
    hd = D // num_heads
    kh = kh.reshape(B, T, num_heads, hd).float()
    wq, bq = _heads_w(p["q"], num_heads)
    wk = torch.einsum("chd,bthd->bhtc", wq.float(), kh) * hd**-0.5
    off = torch.einsum("hd,bthd->bht", bq.float(), kh) * hd**-0.5
    wo = p["out"]["w"].reshape(num_heads, hd, -1).float()
    vo = torch.einsum("bthd,hde->bhte", vh.reshape(B, T, num_heads, hd).float(), wo)
    pad = tp - T
    w = F.pad(wk, (0, 0, 0, pad)).permute(0, 3, 1, 2).reshape(B, k_tok.shape[-1], num_heads * tp)
    off = F.pad(off, (0, pad), value=-1e30).reshape(B, num_heads * tp)
    vo = F.pad(vo, (0, 0, 0, pad)).reshape(B, num_heads * tp, -1)
    return w, off, vo, p["out"]["b"].float()


def _i2t_prep_shared_q(p, k_tok, v_tok, num_heads: int, tp: int):
    """The same operands for the layer-0 site whose score side is the once-
    projected image queries: w is the block-diagonal per-head key projection
    (reference decoder.py:584)."""
    kh, vh = _lin(p["k"], k_tok), _lin(p["v"], v_tok)
    B, T, D = kh.shape
    hd = D // num_heads
    kh = kh.reshape(B, T, num_heads, hd).float() * hd**-0.5
    eye = torch.eye(num_heads, dtype=torch.float32, device=kh.device)
    w = F.pad(torch.einsum("btnd,nm->bndmt", kh, eye), (0, tp - T)).reshape(B, D, num_heads * tp)
    off = torch.zeros((B, num_heads, tp), dtype=torch.float32, device=kh.device)
    off[:, :, T:] = -1e30
    wo = p["out"]["w"].reshape(num_heads, hd, -1).float()
    vo = torch.einsum("btnd,nde->bnte", vh.reshape(B, T, num_heads, hd).float(), wo)
    vo = F.pad(vo, (0, 0, 0, tp - T)).reshape(B, num_heads * tp, -1)
    return w, off.reshape(B, num_heads * tp), vo, p["out"]["b"].float()


def _prep_i2t(p, num_heads: int):
    """Image->token site (reference decoder.py:188): w, off and vo each
    become one matmul from the token streams (scale folded):

      wk[b,t,h,:]  = k_tok[b,t] @ (W_k_h W_q_h^T) + b_k_h W_q_h^T
      off[b,h,t]   = k_tok[b,t] @ (W_k_h b_q_h)   + b_k_h . b_q_h
      vo[b,h,t,:]  = v_tok[b,t] @ (W_v_h W_out_h) + b_v_h W_out_h
    """
    wq, bq = _heads_w(p["q"], num_heads)
    wk, bk = _heads_w(p["k"], num_heads)
    wq, bq, wk, bk = wq.float(), bq.float(), wk.float(), bk.float()
    scale = wq.shape[-1] ** -0.5
    B_ = torch.einsum("chd,ehd->hce", wk, wq) * scale
    c_ = torch.einsum("hd,ehd->he", bk, wq) * scale
    d_ = torch.einsum("chd,hd->hc", wk, bq) * scale  # [h, C]
    e_ = torch.einsum("hd,hd->h", bk, bq) * scale  # [h]
    wv, bv = _heads_w(p["v"], num_heads)
    wo = p["out"]["w"].reshape(num_heads, wq.shape[-1], -1).float()
    V_ = torch.einsum("chd,hde->hce", wv.float(), wo)
    f_ = torch.einsum("hd,hde->he", bv.float(), wo)
    C = B_.shape[1]
    dt = p["q"]["w"].dtype
    return {
        # one matmul yields scores and offsets: [C, h*C + h]
        "so_w": torch.cat([B_.permute(1, 0, 2).reshape(C, -1), d_.T], dim=-1).to(dt),
        "so_b": torch.cat([c_.reshape(-1), e_]),
        "vo_w": V_.permute(1, 0, 2).reshape(C, -1).to(dt),  # [C, h*C]
        "vo_b": f_.reshape(-1),
        "const": p["out"]["b"].float(),
        # the shared-q site (decoder layer 0) takes the raw scaled key
        # projection for its block-diagonal score weights
        "k_w_scaled": (p["k"]["w"].float() * scale).to(dt),
        "k_b_scaled": p["k"]["b"].float() * scale,
    }


def _f32_dot(x, prep, key: str):
    """x @ prep[key] with the operands in the weight's dtype and an f32 result
    (the reference's ``preferred_element_type=float32``); the weight's f32
    copy is taken from the prepared products where they hold one."""
    w = prep[key]
    w32 = prep[key + "_f32"] if key + "_f32" in prep else w.float()
    return torch.matmul(x.to(w.dtype).float(), w32)


def _vo_from_prepared(prep, v_tok, num_heads: int, tp: int):
    B, T, _ = v_tok.shape
    vo = (_f32_dot(v_tok, prep, "vo_w") + prep["vo_b"]).reshape(B, T, num_heads, -1)
    return F.pad(vo.permute(0, 2, 1, 3), (0, 0, 0, tp - T)).reshape(B, num_heads * tp, -1)


def _i2t_from_prepared(prep, k_tok, v_tok, num_heads: int, tp: int):
    """(w [B, C, GT], off [B, GT], vo [B, GT, C], const) of
    :func:`_i2t_prep_generic` from the prepared products: two matmuls on the
    token side (reference decoder.py:227)."""
    B, T, C = k_tok.shape
    hC = prep["vo_w"].shape[-1]
    so = _f32_dot(k_tok, prep, "so_w") + prep["so_b"]  # [B, T, h*C + h]
    wk = so[..., :hC].reshape(B, T, num_heads, -1)  # [B, T, h, C]
    off = so[..., hC:].permute(0, 2, 1)  # [B, h, T]
    pad = tp - T
    w = F.pad(wk.permute(0, 3, 2, 1), (0, pad)).reshape(B, C, num_heads * tp)
    off = F.pad(off, (0, pad), value=-1e30).reshape(B, num_heads * tp)
    return w, off, _vo_from_prepared(prep, v_tok, num_heads, tp), prep["const"]


def _i2t_shared_q_from_prepared(prep, k_tok, v_tok, num_heads: int, tp: int):
    """:func:`_i2t_prep_shared_q` from the prepared products: the block-
    diagonal score weights come from the pre-scaled key projection
    (reference decoder.py:265)."""
    B, T, _ = k_tok.shape
    kh = _f32_dot(k_tok, prep, "k_w_scaled") + prep["k_b_scaled"]  # [B, T, D], scale folded
    D = kh.shape[-1]
    kh = kh.reshape(B, T, num_heads, D // num_heads)
    eye = torch.eye(num_heads, dtype=torch.float32, device=kh.device)
    w = F.pad(torch.einsum("btnd,nm->bndmt", kh, eye), (0, tp - T)).reshape(B, D, num_heads * tp)
    off = torch.zeros((B, num_heads, tp), dtype=torch.float32, device=kh.device)
    off[:, :, T:] = -1e30
    return w, off.reshape(B, num_heads * tp), _vo_from_prepared(prep, v_tok, num_heads, tp), prep["const"]


def _i2t_operands(layer, k_tok, v_tok, num_heads: int, tp: int, shared_q: bool):
    """The image->token site's kernel operands, from the layer's prepared
    products when it has them, and its norm4 vectors (f32 when prepared)."""
    prep = layer.get("prepared_i2t")
    if prep is None:
        build = _i2t_prep_shared_q if shared_q else _i2t_prep_generic
        return (*build(layer["cross_i2t"], k_tok, v_tok, num_heads, tp), layer["norm4"]["scale"], layer["norm4"]["bias"])
    build = _i2t_shared_q_from_prepared if shared_q else _i2t_from_prepared
    return (*build(prep, k_tok, v_tok, num_heads, tp), prep["ln_scale"], prep["ln_bias"])


def _prep_upscale(u, C: int):
    """The upscale tail's operands as K4 takes them: each deconv (kernel ==
    stride == 2) as a per-pixel matrix in the param dtype, columns (i, j, c4)
    and (e, f, c8), and the bias and LayerNorm vectors in f32."""
    u1, u2, ln = u["deconv1"], u["deconv2"], u["ln"]
    c4, c8 = u1["w"].shape[-1], u2["w"].shape[-1]
    return {
        "w1": u1["w"].permute(2, 0, 1, 3).reshape(C, 4 * c4).contiguous(),
        "w2": u2["w"].permute(2, 0, 1, 3).reshape(c4, 4 * c8).contiguous(),
        "b1": u1["b"].float().contiguous(),
        "ln_s": ln["scale"].float().contiguous(),
        "ln_b": ln["bias"].float().contiguous(),
        "b2": u2["b"].float().contiguous(),
    }


def prepare_decoder_params(p_dec, cfg: SamConfig):
    """A copy of the decoder params with the products that depend on the
    weights alone added (the reference's decoder.py:332), consumed by
    ``two_way_transformer`` and ``predict_masks`` when present. Exact matmul
    reassociations: the results agree with the raw tree's within rounding.
    Idempotent."""
    if "output_tokens_prepared" in p_dec:
        return p_dec
    h = cfg.decoder_heads
    tf = dict(p_dec["transformer"])
    layers = []
    for layer in tf["layers"]:
        lp = dict(layer)
        lp["prepared_t2i"] = _prep_t2i(layer["cross_t2i"], h)
        lp["prepared_i2t"] = dict(_prep_i2t(layer["cross_i2t"], h), ln_scale=layer["norm4"]["scale"].float().contiguous(),
                                  ln_bias=layer["norm4"]["bias"].float().contiguous())
        layers.append(lp)
    tf["layers"] = layers
    tf["prepared_final_t2i"] = _prep_t2i(tf["final_attn"], h)
    # the f32 copies of the matrices that enter f32 products (rounded to the param dtype first)
    for prep in [lp["prepared_t2i"] for lp in layers] + [tf["prepared_final_t2i"]]:
        prep["score_w_f32"] = prep["score_w"].float()
    for lp in layers:
        for key in ("so_w", "vo_w", "k_w_scaled"):
            lp["prepared_i2t"][key + "_f32"] = lp["prepared_i2t"][key].float()
    out = dict(p_dec)
    out["transformer"] = tf
    out["upscale"] = dict(p_dec["upscale"], prepared=_prep_upscale(p_dec["upscale"], cfg.prompt_dim))
    # hypernetwork MLPs: one stacked weight set per depth
    out["hyper_prepared"] = [
        {"w": torch.stack([m[d]["w"] for m in p_dec["hyper_mlps"]]), "b": torch.stack([m[d]["b"] for m in p_dec["hyper_mlps"]])}
        for d in range(len(p_dec["hyper_mlps"][0]))
    ]
    out["output_tokens_prepared"] = torch.cat([p_dec["iou_token"], p_dec["mask_tokens"]], dim=0)
    return out


def _layer0_tokens(layer0, point_embedding, k_img, image_embedding, h: int):
    """Layer 0 up to norm3 on the token side; its t2i attends the shared image.
    Layer 0 REPLACES queries with the self-attention output, no residual
    (reference transformer.py:155-156, skip_first_layer_pe)."""
    queries = _attn(layer0["self_attn"], point_embedding, point_embedding, point_embedding, h)
    queries = _ln(layer0["norm1"], queries)
    queries = queries + _attn(layer0["cross_t2i"], queries + point_embedding, k_img, image_embedding, h)
    queries = _ln(layer0["norm2"], queries)
    queries = queries + _mlp_relu(layer0["mlp_fc"], layer0["mlp_proj"], queries)
    return _ln(layer0["norm3"], queries)


def _two_way_fused_passes(p, image_embedding, image_pe, point_embedding, cfg: SamConfig):
    """two_way_transformer(shared_image=True) as fused layer passes (K3,
    reference decoder.py:617): layer i's i2t + norm4 sweep also accumulates
    layer i+1's (or the final attention's) t2i, whose query side (the next
    layer's self-attention and norm1) is token work done before the pass."""
    h = cfg.decoder_heads
    layers = p["layers"]
    dt = point_embedding.dtype
    k_img = image_embedding + image_pe
    queries = _layer0_tokens(layers[0], point_embedding, k_img, image_embedding, h)
    tp = _tp_for(queries.shape[1])
    pe_b = image_pe[None].to(dt).contiguous()
    keys = None
    for i, layer in enumerate(layers):
        q = queries + point_embedding
        w, off, vo, const, ln_s, ln_b = _i2t_operands(layer, q, queries, h, tp, shared_q=i == 0)
        if i == 0:
            qside = _lin(layer["cross_i2t"]["q"], k_img.to(dt))[None].contiguous()  # projected once
            base, shared = image_embedding[None].to(dt).contiguous(), True
        else:
            qside, base, shared = keys, keys, False
        if i + 1 < len(layers):
            nxt = layers[i + 1]
            qn = queries + point_embedding
            queries_n = _ln(nxt["norm1"], queries + _attn(nxt["self_attn"], qn, qn, queries, h))
            t2i, t2i_prep = nxt["cross_t2i"], nxt.get("prepared_t2i")
        else:
            queries_n, t2i, t2i_prep = queries, p["final_attn"], p.get("prepared_final_t2i")
        QW, wvo, const_t, T, tp2 = _t2i_qw(t2i, queries_n + point_embedding, h, prep=t2i_prep)
        keys, ctx = i2t_ln_then_t2i(qside, base, pe_b, w, off, vo, const, ln_s, ln_b, QW, h, tp, shared_qside=shared)
        queries_n = queries_n + _t2i_epilogue(ctx, wvo, const_t, T, tp2, h, dt)
        if i + 1 < len(layers):
            queries_n = _ln(nxt["norm2"], queries_n)
            queries_n = queries_n + _mlp_relu(nxt["mlp_fc"], nxt["mlp_proj"], queries_n)
            queries_n = _ln(nxt["norm3"], queries_n)
        else:
            queries_n = _ln(p["norm_final"], queries_n)
        queries = queries_n
    return queries, keys


def two_way_transformer(p, image_embedding, image_pe, point_embedding, cfg: SamConfig, shared_image: bool = False):
    """Returns (queries [B, T, C], keys [B, g*g, C]) (transformer.py:62-106).

    With ``shared_image`` the image side enters un-batched ([g*g, C]): in
    layer 0 it is identical for every prompt, so its projections run once
    and the [B, g*g, C] image stream first appears as layer 0's
    image->token output. Same math as the batched path."""
    h = cfg.decoder_heads
    queries = point_embedding
    if shared_image and use_fused_pass():
        return _two_way_fused_passes(p, image_embedding, image_pe, point_embedding, cfg)
    if shared_image:
        layer0 = p["layers"][0]
        k_img = image_embedding + image_pe  # [g*g, C], shared
        queries = _layer0_tokens(layer0, point_embedding, k_img, image_embedding, h)
        q = queries + point_embedding
        pi = layer0["cross_i2t"]
        if use_fused_i2t():
            # K7 over the once-projected shared image queries
            tp = _tp_for(q.shape[1])
            w, off, vo, const, ln_s, ln_b = _i2t_operands(layer0, q, queries, h, tp, shared_q=True)
            qproj = _lin(pi["q"], k_img.to(queries.dtype))[None].contiguous()
            keys = i2t_ln_update(qproj, image_embedding[None].to(queries.dtype).contiguous(), w, off, vo, const,
                                 ln_s, ln_b, h, tp)
        else:
            # the shared image queries broadcast against the per-prompt tokens
            out = _sdpa(_lin(pi["q"], k_img)[None], _lin(pi["k"], q), _lin(pi["v"], queries), h)
            keys = _ln(layer0["norm4"], image_embedding[None] + _lin(pi["out"], out))
        image_pe = image_pe[None]
        layers, first = p["layers"][1:], 1
    else:
        keys = image_embedding
        layers, first = p["layers"], 0
    image_pe = image_pe.contiguous()

    for i, layer in enumerate(layers, first):
        if i == 0:
            queries = _attn(layer["self_attn"], queries, queries, queries, h)
        else:
            q = queries + point_embedding
            queries = queries + _attn(layer["self_attn"], q, q, queries, h)
        queries = _ln(layer["norm1"], queries)

        q = queries + point_embedding
        if use_fused_t2i():
            queries = queries + _t2i_fused(layer["cross_t2i"], q, keys, image_pe, h, prep=layer.get("prepared_t2i"))
        else:
            queries = queries + _attn(layer["cross_t2i"], q, keys + image_pe, keys, h)
        queries = _ln(layer["norm2"], queries)
        queries = queries + _mlp_relu(layer["mlp_fc"], layer["mlp_proj"], queries)
        queries = _ln(layer["norm3"], queries)

        q = queries + point_embedding
        if use_fused_i2t():
            tp = _tp_for(q.shape[1])
            w, off, vo, const, ln_s, ln_b = _i2t_operands(layer, q, queries, h, tp, shared_q=False)
            keys = i2t_ln_update(keys, keys, w, off, vo, const, ln_s, ln_b, h, tp, pe=image_pe)
        else:
            kpe = keys + image_pe
            keys = _ln(layer["norm4"], keys + _attn(layer["cross_i2t"], kpe, q, queries, h))

    q = queries + point_embedding
    if use_fused_t2i():
        queries = queries + _t2i_fused(p["final_attn"], q, keys, image_pe, h, prep=p.get("prepared_final_t2i"))
    else:
        queries = queries + _attn(p["final_attn"], q, keys + image_pe, keys, h)
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

    output_tokens = p_dec.get("output_tokens_prepared")
    if output_tokens is None:
        output_tokens = torch.cat([p_dec["iou_token"], p_dec["mask_tokens"]], dim=0)
    output_tokens = output_tokens.to(dt)
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

    hyper_prep = p_dec.get("hyper_prepared")
    if hyper_prep is not None:  # one stacked product per depth instead of nmt MLP chains
        hyper = mask_tokens_out
        for d, pd in enumerate(hyper_prep):
            hyper = torch.einsum("bmc,mck->bmk", hyper, pd["w"].to(dt)) + pd["b"].to(dt)
            if d < len(hyper_prep) - 1:
                hyper = torch.relu(hyper)
    else:
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
    u1, u2, ln = p_dec["upscale"]["deconv1"], p_dec["upscale"]["deconv2"], p_dec["upscale"]["ln"]
    c4, c8 = u1["w"].shape[-1], u2["w"].shape[-1]
    pu = p_dec["upscale"].get("prepared")
    if pu is None:
        pu = _prep_upscale(p_dec["upscale"], C)
    w1, w2 = pu["w1"].to(dt), pu["w2"].to(dt)  # [C, (i j c4)], [c4, (e f c8)]
    if use_fused_upscale():
        masks = upscale_hyper(src.reshape(B, g * g, C).contiguous(), w1, pu["b1"], pu["ln_s"], pu["ln_b"], w2,
                              pu["b2"], hyper)
    else:
        x = src.reshape(B, g, g, C) @ w1
        x = x.reshape(B, g, g, 2, 2, c4) + u1["b"].to(dt)
        x = layer_norm_2d(ln, x)
        x = F.gelu(x, approximate="none")
        x = (x @ w2).reshape(B, g, g, 2, 2, 2, 2, c8) + u2["b"].to(dt)
        x = F.gelu(x, approximate="none")  # [b, h, w, i, j, e, f, c]
        # rows are (h, i, e) -> 4h+2i+e, cols (w, j, f) -> 4w+2j+f
        masks = torch.einsum("bmc,bhwijefc->bmhiewjf", hyper.float(), x.float())
        masks = masks.reshape(B, n_sel, 4 * g, 4 * g)
    iou_pred = _mlp_stack(p_dec["iou_head"], iou_token_out).float()
    return masks, iou_pred[:, sel]
