"""Seeded weights for SAM and CLIP, made on the device in one draw each.

The plain reference models (``benchref``) are built without storage, given
storage on the device, and filled from one ``torch.randn`` over all their
parameters, each slice scaled as the parameter's kind asks (1 / sqrt(fan-in)
for matrices, ~N(1, 0.02) for norm scales, small biases, position tables
and relative-position tables nonzero). The same values go to the measured
program in its own parameter layout (input-major matrices, HWIO kernels),
re-laid-out on the device (the layout of ``core/convert.py``) and cast to
the serving dtype; ``logit_scale`` stays float32, as the program serves it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchref.clip import CLIP
from benchref.sam import SAM, LayerNorm2d


def _std(module: nn.Module, pname: str, p: torch.Tensor, names: dict):
    """(mean, std) of one parameter's draw."""
    full = names[id(p)]
    if isinstance(module, (nn.LayerNorm, LayerNorm2d)):
        return (1.0, 0.02) if pname == "weight" else (0.0, 0.02)
    if pname.endswith("bias"):
        return 0.0, 0.02
    if isinstance(module, nn.ConvTranspose2d):
        return 0.0, p.shape[0] ** -0.5
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        return 0.0, (p[0].numel()) ** -0.5
    if isinstance(module, nn.MultiheadAttention):  # in_proj_weight [3d, d]
        return 0.0, p.shape[1] ** -0.5
    if "token_embedding" in full:
        return 0.0, 0.02
    if full == "t_pos":
        return 0.0, 0.01
    if full in ("v_class", "v_pos"):
        return 0.0, p.shape[-1] ** -0.5
    if full in ("v_proj", "text_projection"):  # [width, embed]
        return 0.0, p.shape[0] ** -0.5
    if "rel_pos" in full or "pos_embed" in full:
        return 0.0, 0.02
    return 0.0, 1.0  # prompt and decoder embeddings, the PE's Gaussian matrix


@torch.no_grad()
def seeded_model(cls, cfg, generator: torch.Generator, device) -> nn.Module:
    """``cls(cfg)`` on ``device`` in float32, every parameter from one draw of ``generator``."""
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to_empty(device=device).eval()
    names = {id(p): n for n, p in model.named_parameters()}
    params = [(m, pn, p) for m in model.modules() for pn, p in m.named_parameters(recurse=False)]
    total = sum(p.numel() for _, _, p in params)
    flat = torch.randn(total, generator=generator, device=device)
    offset = 0
    for m, pn, p in params:
        mean, std = _std(m, pn, p, names)
        p.copy_(flat[offset: offset + p.numel()].view_as(p)).mul_(std).add_(mean)
        offset += p.numel()
    if hasattr(model, "logit_scale"):
        model.logit_scale.fill_(math.log(1 / 0.07))
    for b in model.buffers():
        b.zero_()
    del flat
    return model


# ---------------------------------------------------------------------------
# the program's parameter layout
# ---------------------------------------------------------------------------


def _t(x):
    return x.t().contiguous()


def _hwio(x):  # torch conv [out, in, kh, kw] -> [kh, kw, in, out]
    return x.permute(2, 3, 1, 0).contiguous()


def _ln(sd, prefix):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _lin(sd, prefix):
    return {"w": _t(sd[f"{prefix}.weight"]), "b": sd[f"{prefix}.bias"]}


def _clip_block(sd, p):
    return {"ln_1": _ln(sd, f"{p}.ln_1"),
            "attn": {"in_proj_w": _t(sd[f"{p}.attn.in_proj_weight"]), "in_proj_b": sd[f"{p}.attn.in_proj_bias"],
                     "out_w": _t(sd[f"{p}.attn.out_proj.weight"]), "out_b": sd[f"{p}.attn.out_proj.bias"]},
            "ln_2": _ln(sd, f"{p}.ln_2"), "mlp_fc": _lin(sd, f"{p}.mlp.c_fc"), "mlp_proj": _lin(sd, f"{p}.mlp.c_proj")}


def clip_tree(model: CLIP) -> dict:
    sd = {k: v.detach() for k, v in model.openai_names().items()}
    cfg = model.cfg
    visual = {"conv1": _hwio(sd["visual.conv1.weight"]), "class_embedding": sd["visual.class_embedding"],
              "positional_embedding": sd["visual.positional_embedding"], "ln_pre": _ln(sd, "visual.ln_pre"),
              "blocks": [_clip_block(sd, f"visual.transformer.resblocks.{i}") for i in range(cfg.vision_layers)],
              "ln_post": _ln(sd, "visual.ln_post"), "proj": sd["visual.proj"]}
    text = {"token_embedding": sd["token_embedding.weight"], "positional_embedding": sd["positional_embedding"],
            "blocks": [_clip_block(sd, f"transformer.resblocks.{i}") for i in range(cfg.text_layers)],
            "ln_final": _ln(sd, "ln_final"), "text_projection": sd["text_projection"]}
    return {"visual": visual, "text": text, "logit_scale": sd["logit_scale"].reshape(())}


def _twoway(sd, p):
    return {k: _lin(sd, f"{p}.{n}") for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                                  ("out", "out_proj"))}


def sam_tree(model: SAM) -> dict:
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


def cast(tree, dtype: torch.dtype):
    """Floating leaves to ``dtype`` (the serving type), ``logit_scale`` kept in float32."""
    if isinstance(tree, dict):
        return {k: v if k == "logit_scale" else cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree
