"""Seeded weights for the proposal model and CLIP, made on the device in one draw each.

The plain reference models (``benchref``) are built without storage, given
storage on the device, and filled from one ``torch.randn`` over all their
parameters, each slice scaled as the parameter's kind asks (1 / sqrt(fan-in)
for matrices, ~N(1, 0.02) for norm scales, small biases, position tables
and relative-position tables nonzero). The same values go to the measured
program in its own parameter layout (input-major matrices, HWIO kernels),
re-laid-out on the device (the layout of ``core/convert.py``) and cast to
the serving dtype; ``logit_scale`` stays float32, as the program serves it.
The proposal model's layout is its family's (``families/<name>.py:program_tree``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchref.clip import CLIP


def _std(module: nn.Module, pname: str, p: torch.Tensor, names: dict):
    """(mean, std) of one parameter's draw."""
    full = names[id(p)]
    if hasattr(module, "eps"):  # a normalisation layer: nn.LayerNorm, a family's channel LayerNorm
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


def cast(tree, dtype: torch.dtype):
    """Floating leaves to ``dtype`` (the serving type), ``logit_scale`` kept in float32."""
    if isinstance(tree, dict):
        return {k: v if k == "logit_scale" else cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree
