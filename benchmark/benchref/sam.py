"""Plain-PyTorch SAM (image encoder, prompt encoder, mask decoder) in the
upstream ``segment_anything`` layout and parameter names.

Source: a frozen copy of ``tests/torch_ref_sam.py`` (the test suite's
independent restatement of upstream ``segment_anything/modeling``), with its
config import removed and every constant made on the input's device. It
imports nothing of the measured program.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class LayerNorm2d(nn.Module):
    def __init__(self, c, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):  # NCHW
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class EncAttention(nn.Module):
    def __init__(self, dim, heads, size):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x):  # [B, H, W, C]
        B, H, W, _ = x.shape
        dev = x.device
        qkv = self.qkv(x).reshape(B, H * W, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.heads, H * W, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        # decomposed relative positions (upstream image_encoder.py:319-352)
        idx = torch.arange(H, device=dev)[:, None] - torch.arange(H, device=dev)[None, :] + H - 1
        Rh = self.rel_pos_h[idx]
        idx = torch.arange(W, device=dev)[:, None] - torch.arange(W, device=dev)[None, :] + W - 1
        Rw = self.rel_pos_w[idx]
        r_q = q.reshape(B * self.heads, H, W, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
        attn = (attn.view(-1, H, W, H, W) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).view(-1, H * W, H * W)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(B, self.heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(x)


def window_partition(x, ws):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(w, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = w.shape[0] // (Hp * Wp // ws // ws)
    x = w.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


class EncBlock(nn.Module):
    def __init__(self, dim, heads, window, grid):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EncAttention(dim, heads, window if window else grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.ModuleDict({"lin1": nn.Linear(dim, dim * 4), "lin2": nn.Linear(dim * 4, dim)})
        self.window = window

    def forward(self, x):
        sc = x
        x = self.norm1(x)
        if self.window:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window)
            x = self.attn(x)
            x = window_unpartition(x, self.window, pad_hw, (H, W))
        else:
            x = self.attn(x)
        x = sc + x
        return x + self.mlp["lin2"](F.gelu(self.mlp["lin1"](self.norm2(x))))


class SamEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        g = cfg.embed_grid
        self.patch_embed = nn.ModuleDict({"proj": nn.Conv2d(3, cfg.encoder_width, cfg.patch_size, cfg.patch_size)})
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.encoder_width))
        self.blocks = nn.ModuleList([
            EncBlock(cfg.encoder_width, cfg.encoder_heads, 0 if i in cfg.encoder_global_idx else cfg.window_size, g)
            for i in range(cfg.encoder_depth)
        ])
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.encoder_width, cfg.prompt_dim, 1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
            nn.Conv2d(cfg.prompt_dim, cfg.prompt_dim, 3, padding=1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
        )

    def forward(self, x):  # NCHW
        x = self.patch_embed["proj"](x).permute(0, 2, 3, 1)
        x = x + self.pos_embed
        for b in self.blocks:
            x = b(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PromptEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.pe_layer = nn.ParameterDict(
            {"positional_encoding_gaussian_matrix": nn.Parameter(torch.zeros(2, cfg.prompt_dim // 2))})
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, cfg.prompt_dim) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, cfg.prompt_dim)
        self.no_mask_embed = nn.Embedding(1, cfg.prompt_dim)
        mc = cfg.mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, 2), LayerNorm2d(mc // 4), nn.GELU(),
            nn.Conv2d(mc // 4, mc, 2, 2), LayerNorm2d(mc), nn.GELU(),
            nn.Conv2d(mc, cfg.prompt_dim, 1),
        )

    def _pe(self, coords):
        coords = 2 * coords - 1
        coords = coords @ self.pe_layer["positional_encoding_gaussian_matrix"]
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def dense_pe(self):
        g = self.cfg.embed_grid
        dev = self.no_mask_embed.weight.device
        y = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        x = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        grid = torch.stack([x[None, :].expand(g, g), y[:, None].expand(g, g)], dim=-1)
        return self._pe(grid).permute(2, 0, 1)  # C, H, W

    def embed_points(self, coords, labels):
        """Point prompts with the padding point (upstream prompt_encoder.py:76-94)."""
        B, dev = coords.shape[0], coords.device
        coords = torch.cat([coords, torch.zeros(B, 1, 2, device=dev)], dim=1) + 0.5
        labels = torch.cat([labels, -torch.ones(B, 1, device=dev)], dim=1)
        coords = coords / self.cfg.img_size
        emb = self._pe(coords)
        emb[labels == -1] = 0.0
        emb[labels == -1] += self.not_a_point_embed.weight[0]
        emb[labels == 0] += self.point_embeddings[0].weight[0]
        emb[labels == 1] += self.point_embeddings[1].weight[0]
        return emb

    def no_mask_dense(self):
        g = self.cfg.embed_grid
        return self.no_mask_embed.weight[0][:, None, None].expand(-1, g, g)


class TwoWayAttn(nn.Module):
    def __init__(self, dim, heads, downsample=1):
        super().__init__()
        self.di = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, self.di)
        self.k_proj = nn.Linear(dim, self.di)
        self.v_proj = nn.Linear(dim, self.di)
        self.out_proj = nn.Linear(self.di, dim)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b = q.shape[0]

        def heads(t):
            return t.reshape(b, t.shape[1], self.heads, -1).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)
        attn = q @ k.transpose(-2, -1) / math.sqrt(q.shape[-1])
        out = attn.softmax(-1) @ v
        out = out.transpose(1, 2).reshape(b, -1, self.di)
        return self.out_proj(out)


class TwoWayBlock(nn.Module):
    def __init__(self, dim, heads, mlp_dim, skip_pe):
        super().__init__()
        self.self_attn = TwoWayAttn(dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = TwoWayAttn(dim, heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.ModuleDict({"lin1": nn.Linear(dim, mlp_dim), "lin2": nn.Linear(mlp_dim, dim)})
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = TwoWayAttn(dim, heads, 2)
        self.skip_pe = skip_pe

    def forward(self, queries, keys, qpe, kpe):
        if self.skip_pe:
            # layer 0 replaces the queries (upstream transformer.py:155-156)
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + qpe, keys + kpe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp["lin2"](F.relu(self.mlp["lin1"](queries))))
        q, k = queries + qpe, keys + kpe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.prompt_dim
        self.cfg = cfg
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(cfg.num_mask_tokens, d)
        self.layers = nn.ModuleList([TwoWayBlock(d, cfg.decoder_heads, cfg.decoder_mlp_dim, i == 0)
                                     for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = TwoWayAttn(d, cfg.decoder_heads, 2)
        self.norm_final_attn = nn.LayerNorm(d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList([
            nn.ModuleDict({"layers": nn.ModuleList([nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d // 8)])})
            for _ in range(cfg.num_mask_tokens)
        ])
        hid = cfg.iou_head_hidden
        self.iou_prediction_head = nn.ModuleDict({"layers": nn.ModuleList([
            nn.Linear(d, hid), nn.Linear(hid, hid), nn.Linear(hid, cfg.num_mask_tokens)])})

    @staticmethod
    def _mlp(md, x):
        ls = md["layers"]
        for i, layer in enumerate(ls):
            x = layer(x)
            if i < len(ls) - 1:
                x = F.relu(x)
        return x

    def forward(self, emb, pe, sparse, dense, multimask=True):
        """emb [C, g, g] (or [B, C, g, g]), pe [C, g, g], sparse [B, T, C],
        dense [C, g, g] or [B, C, g, g] -> (logits [B, M, 4g, 4g], iou [B, M])."""
        B = sparse.shape[0]
        out_tok = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tok[None].expand(B, -1, -1), sparse], 1)
        emb = emb[None].expand(B, -1, -1, -1) if emb.ndim == 3 else emb
        src = emb + dense
        b, c, h, w = src.shape
        queries = tokens
        keys = src.flatten(2).permute(0, 2, 1)
        kpe = pe[None].expand(B, -1, -1, -1).flatten(2).permute(0, 2, 1)
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, kpe)
        q, k = queries + tokens, keys + kpe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        queries = self.norm_final_attn(queries)
        iou_out = queries[:, 0]
        mask_toks = queries[:, 1: 1 + self.cfg.num_mask_tokens]
        src2 = keys.transpose(1, 2).reshape(b, c, h, w)
        up = self.output_upscaling(src2)
        hyper = torch.stack([self._mlp(self.output_hypernetworks_mlps[i], mask_toks[:, i])
                             for i in range(self.cfg.num_mask_tokens)], 1)
        bb, cc, hh, ww = up.shape
        masks = (hyper @ up.view(bb, cc, hh * ww)).view(bb, -1, hh, ww)
        iou = self._mlp(self.iou_prediction_head, iou_out)
        sl = slice(1, None) if multimask else slice(0, 1)
        return masks[:, sl], iou[:, sl]


class SAM(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = SamEncoder(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def upstream_names(self):
        """{upstream checkpoint name: parameter} (segment_anything's layout)."""
        out = {}
        for k, v in self.named_parameters():
            k = k.replace("mask_decoder.layers.", "mask_decoder.transformer.layers.")
            k = k.replace("mask_decoder.final_attn_token_to_image.",
                          "mask_decoder.transformer.final_attn_token_to_image.")
            k = k.replace("mask_decoder.norm_final_attn.", "mask_decoder.transformer.norm_final_attn.")
            out[k] = v
        return out
