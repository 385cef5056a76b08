"""The SAM ViTDet family (``segment_anything``'s ViT-B/L/H): the adapter of
``benchlib/families`` (its contract: ``benchlib/config.py``).

The image goes into SAM's square frame resized by its long side and padded
at the bottom and right; the encoder gives one embedding map; the decoder
upscales it twice; a mask goes back to a crop through the frame's size and
its valid corner (upstream ``postprocess_masks``). A layer-1 crop is resized
into the frame by a bilinear resize of the image without rounding (the
reference package's; upstream rounds it through PIL), a sample by PIL with
rounding, as the program's sample builder does.

``program_tree`` lays the weights out as the program's ``core/convert.py``
does; ``encoder_flops`` and ``decode_flops`` are a frozen copy of the program's
``utils/flops.py`` (``sam_encoder_flops``, ``sam_decode_flops``);
``proposal_launches`` follows the kernel table of ``PERF.md``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from benchref.sam import SAM
from benchref.spec import sam_spec

from ..flops import _mm, vit_block_flops
from ..weights import _hwio, _lin, _ln, _t, seeded_model


def spec(sam: dict):
    """The reference's settings of the configuration's ``sam`` group."""
    return sam_spec(sam)


def reference_model(spec, generator: torch.Generator, device) -> SAM:
    """The seeded float32 reference SAM (drawn before CLIP, from the same generator)."""
    return seeded_model(SAM, spec, generator, device)


def program_config(sam: dict):
    """The program's ``SamConfig`` of the configuration's ``sam`` group."""
    from hybridgl_tpu_torch.core.config import SamConfig

    sam = dict(sam)
    for k in ("encoder_global_idx", "pixel_mean", "pixel_std"):
        sam[k] = tuple(sam[k])
    return SamConfig(**sam)


# ---------------------------------------------------------------------------
# the frame, the encoder, the decoder and the way back to a crop
# ---------------------------------------------------------------------------


def preprocess_shape(h: int, w: int, long_side: int):
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def frame(spec, image):
    """(frame [S, S, 3], rh, rw): ``image`` [h, w, 3] resized by its long side
    to (rh, rw) at the frame's top left, zeros elsewhere. A uint8 array (a
    sample) is resized through PIL and stays uint8; a tensor (a crop of the
    image on the device) is resized in float32 without rounding."""
    S = spec.img_size
    rh, rw = preprocess_shape(image.shape[0], image.shape[1], S)
    if isinstance(image, np.ndarray):
        resized = np.asarray(Image.fromarray(image).resize((rw, rh), Image.BILINEAR))
        out = np.zeros((S, S) + image.shape[2:], image.dtype)
        out[:rh, :rw] = resized
        return out, rh, rw
    x = F.interpolate(image.permute(2, 0, 1)[None].float(), (rh, rw), mode="bilinear", align_corners=False)
    return F.pad(x[0].permute(1, 2, 0), (0, 0, 0, S - rw, 0, S - rh)), rh, rw


def encode(model: SAM, frame, rh: int, rw: int) -> torch.Tensor:
    """The embedding [1, C, g, g] of a frame: its valid corner normalised, zeros padded after the normalisation."""
    spec = model.cfg
    S = spec.img_size
    dev = next(model.parameters()).device
    mean = torch.tensor(spec.pixel_mean, device=dev)[:, None, None]
    std = torch.tensor(spec.pixel_std, device=dev)[:, None, None]
    x = torch.as_tensor(frame, device=dev)[:rh, :rw].permute(2, 0, 1).float()
    x = (x - mean) / std
    return model.image_encoder(F.pad(x, (0, S - rw, 0, S - rh))[None])


def decode(model: SAM, embedding: torch.Tensor, coords: torch.Tensor):
    """Points [n, 2] in the frame -> (logits [n, 3, 4g, 4g], iou [n, 3])."""
    pe = model.prompt_encoder
    sparse = pe.embed_points(coords[:, None, :], torch.ones(len(coords), 1, device=coords.device))
    return model.mask_decoder(embedding[0], pe.dense_pe(), sparse, pe.no_mask_dense(), multimask=True)


def to_crop(spec, logits: torch.Tensor, shape, crop_hw) -> torch.Tensor:
    """Upstream postprocess_masks: up to the frame, its valid corner ``shape`` (rh, rw), down to the crop's size."""
    S = spec.img_size
    x = F.interpolate(logits, (S, S), mode="bilinear", align_corners=False)[..., : shape[0], : shape[1]]
    return F.interpolate(x, crop_hw, mode="bilinear", align_corners=False)


# ---------------------------------------------------------------------------
# the program's parameter layout
# ---------------------------------------------------------------------------


def _twoway(sd, p):
    return {k: _lin(sd, f"{p}.{n}") for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                                  ("out", "out_proj"))}


def program_tree(model: SAM) -> dict:
    """The program's SAM parameter tree (``core/params.py``'s layout) of the seeded reference model."""
    sd = {k: v.detach() for k, v in model.upstream_names().items()}
    cfg = model.cfg
    enc, pe, de = "image_encoder", "prompt_encoder", "mask_decoder"

    def block(p):
        return {"ln_1": _ln(sd, f"{p}.norm1"),
                "attn": {"qkv_w": _t(sd[f"{p}.attn.qkv.weight"]), "qkv_b": sd[f"{p}.attn.qkv.bias"],
                         "proj_w": _t(sd[f"{p}.attn.proj.weight"]), "proj_b": sd[f"{p}.attn.proj.bias"],
                         "rel_pos_h": sd[f"{p}.attn.rel_pos_h"], "rel_pos_w": sd[f"{p}.attn.rel_pos_w"]},
                "ln_2": _ln(sd, f"{p}.norm2"), "mlp_fc": _lin(sd, f"{p}.mlp.lin1"),
                "mlp_proj": _lin(sd, f"{p}.mlp.lin2")}

    def conv(p, bias=True):
        out = {"w": _hwio(sd[f"{p}.weight"])}
        if bias:
            out["b"] = sd[f"{p}.bias"]
        return out

    def deconv(p):  # ConvTranspose2d [in, out, kh, kw] -> [kh, kw, in, out]
        return {"w": sd[f"{p}.weight"].permute(2, 3, 0, 1).contiguous(), "b": sd[f"{p}.bias"]}

    encoder = {"patch_embed": conv(f"{enc}.patch_embed.proj"), "pos_embed": sd[f"{enc}.pos_embed"],
               "blocks": [block(f"{enc}.blocks.{i}") for i in range(cfg.encoder_depth)],
               "neck": {"conv1_w": _hwio(sd[f"{enc}.neck.0.weight"]), "ln1": _ln(sd, f"{enc}.neck.1"),
                        "conv2_w": _hwio(sd[f"{enc}.neck.2.weight"]), "ln2": _ln(sd, f"{enc}.neck.3")}}
    prompt = {"pe_gaussian": sd[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"],
              "point_embeddings": torch.stack([sd[f"{pe}.point_embeddings.{i}.weight"][0] for i in range(4)]),
              "not_a_point_embed": sd[f"{pe}.not_a_point_embed.weight"][0],
              "no_mask_embed": sd[f"{pe}.no_mask_embed.weight"][0],
              "mask_downscaling": {"conv1": conv(f"{pe}.mask_downscaling.0"), "ln1": _ln(sd, f"{pe}.mask_downscaling.1"),
                                   "conv2": conv(f"{pe}.mask_downscaling.3"),
                                   "ln2": _ln(sd, f"{pe}.mask_downscaling.4"),
                                   "conv3": conv(f"{pe}.mask_downscaling.6")}}
    tr = f"{de}.transformer"
    layers = [{"self_attn": _twoway(sd, f"{tr}.layers.{i}.self_attn"), "norm1": _ln(sd, f"{tr}.layers.{i}.norm1"),
               "cross_t2i": _twoway(sd, f"{tr}.layers.{i}.cross_attn_token_to_image"),
               "norm2": _ln(sd, f"{tr}.layers.{i}.norm2"), "mlp_fc": _lin(sd, f"{tr}.layers.{i}.mlp.lin1"),
               "mlp_proj": _lin(sd, f"{tr}.layers.{i}.mlp.lin2"), "norm3": _ln(sd, f"{tr}.layers.{i}.norm3"),
               "norm4": _ln(sd, f"{tr}.layers.{i}.norm4"),
               "cross_i2t": _twoway(sd, f"{tr}.layers.{i}.cross_attn_image_to_token")}
              for i in range(cfg.decoder_depth)]
    decoder = {"iou_token": sd[f"{de}.iou_token.weight"], "mask_tokens": sd[f"{de}.mask_tokens.weight"],
               "transformer": {"layers": layers, "final_attn": _twoway(sd, f"{tr}.final_attn_token_to_image"),
                               "norm_final": _ln(sd, f"{tr}.norm_final_attn")},
               "upscale": {"deconv1": deconv(f"{de}.output_upscaling.0"), "ln": _ln(sd, f"{de}.output_upscaling.1"),
                           "deconv2": deconv(f"{de}.output_upscaling.3")},
               "hyper_mlps": [[_lin(sd, f"{de}.output_hypernetworks_mlps.{i}.layers.{j}") for j in range(3)]
                              for i in range(cfg.num_mask_tokens)],
               "iou_head": [_lin(sd, f"{de}.iou_prediction_head.layers.{j}") for j in range(3)]}
    return {"encoder": encoder, "prompt": prompt, "decoder": decoder}



# ---------------------------------------------------------------------------
# the FLOP model and the kernel launches
# ---------------------------------------------------------------------------


def encoder_flops(sam) -> float:
    """ImageEncoderViT forward on one 1024^2 frame.

    Windowed blocks attend within window_size^2 tokens over a padded
    (ceil(G/ws)*ws)^2 grid (reference: image_encoder.py:243-289); global
    blocks attend over all G^2 tokens. The decomposed rel-pos einsums
    (reference: image_encoder.py:292-361) contribute
    2*T_attn*(Sh+Sw)*head_dim per head — included.
    """
    G = sam.embed_grid  # 64
    T = G * G
    W = sam.encoder_width
    ws = sam.window_size
    Gp = math.ceil(G / ws) * ws
    T_win = Gp * Gp  # padded token count actually attending in windows
    n_global = len(sam.encoder_global_idx)
    n_win = sam.encoder_depth - n_global

    def relpos(T_attn, side):
        # q @ rel_h + q @ rel_w per head: 2 * T_attn * side * head_dim * H
        return 2 * _mm(T_attn, side, W)

    win = vit_block_flops(T, ws * ws, W, sam.mlp_ratio, T_attn=T_win) + relpos(
        T_win, ws
    )
    glo = vit_block_flops(T, T, W, sam.mlp_ratio) + relpos(T, G)
    patch = _mm(T, W, sam.patch_size * sam.patch_size * 3)
    neck = _mm(T, sam.prompt_dim, W) + _mm(T, sam.prompt_dim, sam.prompt_dim * 9)
    return n_win * win + n_global * glo + patch + neck


def decode_flops(sam, n_points: int) -> float:
    """Prompt-encode + TwoWayTransformer + upscale + hypernetwork product
    for ``n_points`` single-point prompts (multimask).

    Two-way layers run {token self-attn, t2i, MLP, i2t} at attention
    channel dim prompt_dim/2 (reference: transformer.py:109-182,
    downsample_rate=2); the output upscaling is two stride-2 deconvs
    (reference: mask_decoder.py:53-59).

    This is the CANONICAL (reference-architecture) count, the one an MFU
    figure uses: MFU divides the model's defined work by time, so
    algorithmic savings of the implementation (side-switched cross
    attentions, shared layer-0 image side) show up as throughput, not as
    an MFU discount. What the decoder actually executes is the program's
    ``utils/flops.py:sam_decode_flops_executed``, ~45% LOWER at production shapes.
    """
    B = n_points
    D = sam.prompt_dim  # 256
    Da = D // 2  # attention channels (downsample 2)
    G = sam.embed_grid
    Ti = G * G  # image tokens
    Tt = sam.num_mask_tokens + 1 + 2  # mask+iou tokens + point + pad  ~7
    per_layer = (
        # token self-attn (q/k/v/out at Da) + scores
        _mm(Tt, 3 * Da, D) + _mm(Tt, Da, D) + 2 * _mm(Tt, Tt, Da)
        # t2i: q from tokens, k/v from image
        + _mm(Tt, Da, D) + _mm(Ti, 2 * Da, D) + _mm(Tt, Da, D)
        + 2 * _mm(Tt, Ti, Da)
        # token MLP
        + 2 * _mm(Tt, sam.decoder_mlp_dim, D)
        # i2t: q from image, k/v from tokens
        + _mm(Ti, Da, D) + _mm(Tt, 2 * Da, D) + _mm(Ti, Da, D)
        + 2 * _mm(Ti, Tt, Da)
    )
    final_attn = _mm(Tt, Da, D) + _mm(Ti, 2 * Da, D) + _mm(Tt, Da, D) + 2 * _mm(
        Tt, Ti, Da
    )
    # upscale deconvs 2x2/s2: each output pixel sees exactly one weight tap
    up1 = _mm((2 * G) ** 2, D // 4, D)
    up2 = _mm((4 * G) ** 2, D // 8, D // 4)
    hyper = sam.num_mask_tokens * 3 * _mm(1, D // 8, D)  # 3-layer MLPs
    mask_prod = _mm(sam.num_mask_tokens, (4 * G) ** 2, D // 8)
    iou_head = sam.iou_head_depth * _mm(1, sam.iou_head_hidden, D)
    return B * (
        sam.decoder_depth * per_layer
        + final_attn
        + up1
        + up2
        + hyper
        + mask_prod
        + iou_head
    )


def proposal_launches(settings, windows) -> list:
    """[(kernel, shapes)] of one image's proposal stage; ``windows`` the
    (height, width) of each crop's window in the canonical frame (the full
    image first)."""
    sam, amg = settings.sam, settings.amg
    g, ws, d, heads = sam.embed_grid, sam.window_size, sam.encoder_width, sam.encoder_heads
    hd = d // heads
    n_win = math.ceil(g / ws) ** 2
    n_global = len(sam.encoder_global_idx)
    C, S, B = sam.prompt_dim, g * g, amg.points_per_batch
    out = []
    for _ in windows:  # one encoder pass a crop
        out += [("flash_windowed_fused", dict(BH=n_win * heads, S=ws * ws, hd=hd, G=ws, esize=2))] * (
            sam.encoder_depth - n_global)
        out += [("flash_attention_fused", dict(BH=heads, S=S, hd=hd, G=g, esize=2))] * n_global
    sides = [amg.points_per_side] + [int(amg.points_per_side / amg.crop_n_points_downscale_factor)] * (len(windows) - 1)
    n_low = 4 * g
    for (dh, dw), side in zip(windows, sides):
        chunks = -(-side * side // B)
        for _ in range(chunks):
            out.append(("i2t_ln_then_t2i", dict(B=B, S=S, C=C, Cq=C // 2, GT=64, shared=True, esize=2)))
            out.append(("i2t_ln_then_t2i", dict(B=B, S=S, C=C, Cq=C, GT=64, shared=False, esize=2)))
            out.append(("upscale_hyper_blocked", dict(B=B, S=S, C=C, c4=C // 4, c8=C // 8, m=3, esize=2)))
            out.append(("pass1_stats_half", dict(B=B * 3, n=n_low, C=settings.canonical_size, dh=dh, dw=dw,
                                                 esize=2)))
        out.append(("nms", dict(N=chunks * B * 3, read_words=chunks * B * 3)))
    if len(windows) > 1:  # cross-crop NMS and the batched pass-2 re-decode
        K, P = amg.max_candidates_per_crop, amg.max_proposals
        out.append(("nms", dict(N=len(windows) * K, read_words=len(windows) * K)))
        out += [("i2t_ln_update", dict(B=P, S=S, C=C, Cq=C, GT=64))] * 2
        out += [("t2i_ctx", dict(B=P, S=S, C=C, Cq=C, GT=64))] * 3
        out.append(("upscale_hyper_blocked", dict(B=P, S=S, C=C, c4=C // 4, c8=C // 8, m=3, esize=2)))
    return out
