"""Plain-PyTorch CLIP ViT (image and text towers, OpenAI layout and
parameter names), the HybridGL G2L fusion forward and the GEM patch
features.

Sources: frozen copies of ``tests/torch_ref.py`` (``TinyCLIP``,
``torch_hybrid_forward``'s G2L branch and its mask helpers) and
``tests/torch_ref_gem.py`` (``torch_gem_features``), the test suite's
independent restatements of OpenAI CLIP, the reference's
``model/backbone.py`` and the GEM paper (Bousselham et al., CVPR 2024), with
their config imports removed and every constant made on the input's device.
It imports nothing of the measured program.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ResBlock(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.attn = nn.MultiheadAttention(d, h)
        self.ln_1 = nn.LayerNorm(d)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", nn.Linear(d, d * 4)), ("gelu", QuickGELU()),
                                              ("c_proj", nn.Linear(d * 4, d))]))
        self.ln_2 = nn.LayerNorm(d)

    def forward(self, x, attn_mask=None):  # x: [L, N, D]
        y = self.ln_1(x)
        y = self.attn(y, y, y, need_weights=False, attn_mask=attn_mask)[0]
        x = x + y
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads):
        super().__init__()
        self.resblocks = nn.ModuleList([ResBlock(width, heads) for _ in range(layers)])

    def forward(self, x, attn_mask=None):
        for b in self.resblocks:
            x = b(x, attn_mask)
        return x


class CLIP(nn.Module):
    """OpenAI-CLIP ViT visual + text transformer."""

    def __init__(self, cfg):
        super().__init__()
        vw, tw = cfg.vision_width, cfg.text_width
        self.cfg = cfg
        self.v_conv1 = nn.Conv2d(3, vw, cfg.patch_size, cfg.patch_size, bias=False)
        self.v_class = nn.Parameter(torch.zeros(vw))
        self.v_pos = nn.Parameter(torch.zeros(cfg.seq_len, vw))
        self.v_ln_pre = nn.LayerNorm(vw)
        self.v_tr = Transformer(vw, cfg.vision_layers, cfg.vision_heads)
        self.v_ln_post = nn.LayerNorm(vw)
        self.v_proj = nn.Parameter(torch.zeros(vw, cfg.embed_dim))
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.t_pos = nn.Parameter(torch.zeros(cfg.context_length, tw))
        self.t_tr = Transformer(tw, cfg.text_layers, cfg.text_heads)
        self.ln_final = nn.LayerNorm(tw)
        self.text_projection = nn.Parameter(torch.zeros(tw, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07), dtype=torch.float32))

    def visual_stem(self, images):  # [N, 3, H, W] -> [L, N, D]
        x = self.v_conv1(images)
        x = x.reshape(x.shape[0], x.shape[1], -1).permute(0, 2, 1)
        cls = self.v_class + torch.zeros(x.shape[0], 1, x.shape[-1], device=x.device)
        x = torch.cat([cls, x], dim=1) + self.v_pos
        x = self.v_ln_pre(x)
        return x.permute(1, 0, 2)

    def causal_mask(self, device):
        L = self.cfg.context_length
        return torch.full((L, L), float("-inf"), device=device).triu_(1)

    def encode_text(self, tokens):
        x = self.token_embedding(tokens) + self.t_pos
        x = self.t_tr(x.permute(1, 0, 2), self.causal_mask(tokens.device)).permute(1, 0, 2)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection

    def openai_names(self):
        """{OpenAI checkpoint name: parameter}."""
        sd = {"visual.conv1.weight": self.v_conv1.weight, "visual.class_embedding": self.v_class,
              "visual.positional_embedding": self.v_pos, "visual.ln_pre.weight": self.v_ln_pre.weight,
              "visual.ln_pre.bias": self.v_ln_pre.bias}
        for scope, tr in (("visual.transformer", self.v_tr), ("transformer", self.t_tr)):
            for i, b in enumerate(tr.resblocks):
                p = f"{scope}.resblocks.{i}"
                sd[f"{p}.attn.in_proj_weight"] = b.attn.in_proj_weight
                sd[f"{p}.attn.in_proj_bias"] = b.attn.in_proj_bias
                sd[f"{p}.attn.out_proj.weight"] = b.attn.out_proj.weight
                sd[f"{p}.attn.out_proj.bias"] = b.attn.out_proj.bias
                for ln in ("ln_1", "ln_2"):
                    sd[f"{p}.{ln}.weight"] = getattr(b, ln).weight
                    sd[f"{p}.{ln}.bias"] = getattr(b, ln).bias
                sd[f"{p}.mlp.c_fc.weight"] = b.mlp.c_fc.weight
                sd[f"{p}.mlp.c_fc.bias"] = b.mlp.c_fc.bias
                sd[f"{p}.mlp.c_proj.weight"] = b.mlp.c_proj.weight
                sd[f"{p}.mlp.c_proj.bias"] = b.mlp.c_proj.bias
        sd.update({"visual.ln_post.weight": self.v_ln_post.weight, "visual.ln_post.bias": self.v_ln_post.bias,
                   "visual.proj": self.v_proj, "token_embedding.weight": self.token_embedding.weight,
                   "positional_embedding": self.t_pos, "ln_final.weight": self.ln_final.weight,
                   "ln_final.bias": self.ln_final.bias, "text_projection": self.text_projection,
                   "logit_scale": self.logit_scale})
        return sd


# ---------------------------------------------------------------------------
# the G2L fusion (the reference's model/backbone.py:227-260)
# ---------------------------------------------------------------------------


def _attn_mask(masks_grid, num_heads):
    """CLS row allowed only at nonzero mask patches, True = drop (torch's convention)."""
    P, g, _ = masks_grid.shape
    L = g * g + 1
    allowed = torch.ones(P * num_heads, L, L, dtype=torch.bool, device=masks_grid.device)
    patch_ok = (masks_grid.reshape(P, 1, -1) != 0).expand(P, num_heads, g * g)
    allowed[:, 0, 1:] = patch_ok.reshape(P * num_heads, g * g)
    return ~allowed


def _token_mask(x, masks_grid):
    """x [L, P, D]: patch rows times the fractional mask, CLS kept."""
    L, P, D = x.shape
    m = masks_grid.reshape(P, -1).T.unsqueeze(-1)
    return torch.cat([x[:1], x[1:] * m], dim=0)


@torch.no_grad()
def g2l_forward(model, local, glob, masks, masking_block):
    """Hybrid G2L CLS features [P, embed] of local/global crops [P, 3, S, S]
    and the proposals' masks [P, h, w] (float)."""
    cfg = model.cfg
    last = cfg.vision_layers - 2
    mb = masking_block
    heads = cfg.vision_heads

    def head(x):
        x = x.permute(1, 0, 2)
        return model.v_ln_post(x[:, 0, :]) @ model.v_proj

    g = cfg.image_size // cfg.patch_size
    masks_grid = F.interpolate(masks.unsqueeze(1), (g, g), mode="bilinear", align_corners=False)[:, 0]
    attn_mask = _attn_mask(masks_grid, heads)
    blocks = model.v_tr.resblocks
    x = model.visual_stem(local)
    x2 = model.visual_stem(glob)
    P = local.shape[0]
    x1_x2 = torch.cat([x, x2], dim=1)
    for i, b in enumerate(blocks):
        if i >= mb:
            if i == mb:
                x, x2 = x1_x2[:, :P], x1_x2[:, P:]
            x_ori_global = _token_mask(x2.clone(), masks_grid)
            x = b(x_ori_global * 2 + x)
            x2 = b(x2, attn_mask=attn_mask)
        else:
            x1_x2 = b(x1_x2)
        if i == last + 1:
            return head(x)
    raise ValueError("masking block past the last block")


# ---------------------------------------------------------------------------
# GEM patch features
# ---------------------------------------------------------------------------


def _split_heads(t, heads):
    N, L, D = t.shape
    return t.reshape(N, L, heads, D // heads).transpose(1, 2)


@torch.no_grad()
def gem_features(model, images, depth, iters, temp=None):
    """images [N, 3, S, S] normalized -> patch features [N, G*G, E]."""
    cfg = model.cfg
    x = model.v_conv1(images)
    N, D, G, _ = x.shape
    x = x.reshape(N, D, G * G).permute(0, 2, 1)
    cls = model.v_class + torch.zeros(N, 1, D, device=x.device)
    x = torch.cat([cls, x], dim=1)
    pos = model.v_pos
    cls_p, patch_p = pos[:1], pos[1:]
    g0 = int(round(patch_p.shape[0] ** 0.5))
    pp = patch_p.reshape(g0, g0, D).permute(2, 0, 1)[None]
    up = F.interpolate(pp, (G, G), mode="bilinear", align_corners=False)
    pos_new = torch.cat([cls_p, up[0].permute(1, 2, 0).reshape(G * G, D)], dim=0)
    x = model.v_ln_pre(x + pos_new)

    heads = cfg.vision_heads
    hd = D // heads
    temp = hd ** -0.5 if temp is None else temp
    scale = hd ** -0.5
    gem_start = cfg.vision_layers - depth
    x_gem = None
    for i, b in enumerate(model.v_tr.resblocks):
        y = b.ln_1(x)
        qkv = y @ b.attn.in_proj_weight.T + b.attn.in_proj_bias
        q, k, v = (_split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
        if i >= gem_start:
            if x_gem is None:
                x_gem = x
            outs = []
            for t in (q, k, v):
                tn = F.normalize(t, dim=-1, eps=1e-6)
                attn = None
                for _ in range(max(iters, 1)):
                    attn = torch.softmax(temp * tn @ tn.transpose(-1, -2), dim=-1)
                    tn = F.normalize(attn @ tn, dim=-1, eps=1e-6)
                outs.append(attn @ v)
            ss = (outs[0] + outs[1] + outs[2]) / 3.0
            ss = ss.transpose(1, 2).reshape(N, -1, D)
            ss = ss @ b.attn.out_proj.weight.T + b.attn.out_proj.bias
            x_gem = x_gem + ss
        attn = torch.softmax(scale * q @ k.transpose(-1, -2), dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(N, -1, D)
        o = o @ b.attn.out_proj.weight.T + b.attn.out_proj.bias
        x = x + o
        x = x + b.mlp(b.ln_2(x))
    feats = model.v_ln_post(x_gem) @ model.v_proj
    return feats[:, 1:]
