"""CLIP ModifiedResNet visual encoder (port of hybridgl_tpu/models/clip/resnet.py).

Completes the CLIP surface (clip/model.py:10-186): the 3-conv stem with
avgpool, anti-aliased strided bottlenecks (avgpool before the strided
conv), and the QKV attention pooling head. The pipeline is ViT-only; this
is the rest of the public CLIP model family (RN50, RN101, ...).

Images and activations are NHWC and conv weights HWIO, the layout of the
shared param tree; BatchNorm runs in inference mode from the checkpoint's
running statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EXPANSION = 4


def _conv(x, w, stride=1):
    """NHWC x HWIO -> NHWC with XLA's "SAME" padding: the total padding that
    keeps ceil(size / stride) outputs, the odd pixel on the high side."""
    w = torch.as_tensor(w, device=x.device).to(x.dtype)
    pads = []
    for size, k in ((x.shape[2], w.shape[1]), (x.shape[1], w.shape[0])):  # F.pad takes the last dim first
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads), w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _bn(p, x, eps=1e-5):
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = (p["scale"] * inv).to(x.dtype)
    bias = (p["bias"] - p["mean"] * p["scale"] * inv).to(x.dtype)
    return x * scale + bias


def _avg_pool(x, k):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def bottleneck(p, x, stride: int = 1):
    """CLIP's Bottleneck (clip/model.py:10-53): all convs stride 1, an
    avgpool after conv2 when stride > 1; downsample = avgpool + 1x1 conv."""
    identity = x
    out = F.relu(_bn(p["bn1"], _conv(x, p["conv1_w"])))
    out = F.relu(_bn(p["bn2"], _conv(out, p["conv2_w"])))
    if stride > 1:
        out = _avg_pool(out, stride)
    out = _bn(p["bn3"], _conv(out, p["conv3_w"]))
    if "downsample" in p:
        d = p["downsample"]
        if stride > 1:
            identity = _avg_pool(identity, stride)
        identity = _bn(d["bn"], _conv(identity, d["conv_w"]))
    return F.relu(out + identity)


def attention_pool_2d(p, x, num_heads: int):
    """QKV attention pooling (clip/model.py:56-124, the standard path):
    tokens = [mean, pixels] + positional embedding; the output is the pooled
    first token after one MHA with separate projections."""
    N, H, W, C = x.shape
    tokens = x.reshape(N, H * W, C)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)  # [N, HW+1, C]
    tokens = tokens + p["positional_embedding"].to(tokens.dtype)

    def lin(name, t):
        return t @ p[name]["w"].to(t.dtype) + p[name]["b"].to(t.dtype)

    q = lin("q_proj", tokens[:, :1])  # query: the mean token
    k = lin("k_proj", tokens)
    v = lin("v_proj", tokens)
    L = tokens.shape[1]
    hd = q.shape[-1] // num_heads

    def heads(t, n):
        return t.reshape(N, n, num_heads, hd).permute(0, 2, 1, 3)

    qh, kh, vh = heads(q, 1), heads(k, L), heads(v, L)
    attn = torch.einsum("nhqd,nhkd->nhqk", qh.float(), kh.float()) / np.sqrt(hd)
    attn = torch.softmax(attn, dim=-1).to(tokens.dtype)
    out = torch.einsum("nhqk,nhkd->nhqd", attn.float(), vh.float())
    out = out.to(tokens.dtype).permute(0, 2, 1, 3).reshape(N, 1, -1)
    return lin("c_proj", out)[:, 0]


def encode_image_resnet(p, images: torch.Tensor, layers: Sequence[int], heads: int):
    """[N, S, S, 3] -> [N, output_dim] pooled features, f32. The param dtype
    drives the compute dtype, as in the ViT stem."""
    x = images.to(p["conv1_w"].dtype)
    for i in (1, 2, 3):
        x = F.relu(_bn(p[f"bn{i}"], _conv(x, p[f"conv{i}_w"], stride=2 if i == 1 else 1)))
    x = _avg_pool(x, 2)
    for li, n_blocks in enumerate(layers, start=1):
        blocks = p[f"layer{li}"]
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and li > 1) else 1
            x = bottleneck(blocks[bi], x, stride)
    return attention_pool_2d(p["attnpool"], x, heads).float()


# ---------------------------------------------------------------------------
# state-dict conversion (numpy in, numpy out; load with core.params.to_torch)
# ---------------------------------------------------------------------------


def _bn_params(sd, prefix):
    return {
        "scale": sd[f"{prefix}.weight"],
        "bias": sd[f"{prefix}.bias"],
        "mean": sd[f"{prefix}.running_mean"],
        "var": sd[f"{prefix}.running_var"],
    }


def _conv_w(sd, prefix):
    return sd[f"{prefix}.weight"].transpose(2, 3, 1, 0).copy()


def convert_resnet_visual(sd) -> Tuple[dict, Sequence[int], int]:
    """'visual.*' RN state dict (numpy) -> (params, layers, heads)."""
    layers = []
    for li in (1, 2, 3, 4):
        n = len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{li}.")})
        layers.append(n)
    params = {}
    for i in (1, 2, 3):
        params[f"conv{i}_w"] = _conv_w(sd, f"visual.conv{i}")
        params[f"bn{i}"] = _bn_params(sd, f"visual.bn{i}")
    for li, n in enumerate(layers, start=1):
        blocks = []
        for bi in range(n):
            pre = f"visual.layer{li}.{bi}"
            blk = {
                "conv1_w": _conv_w(sd, f"{pre}.conv1"),
                "bn1": _bn_params(sd, f"{pre}.bn1"),
                "conv2_w": _conv_w(sd, f"{pre}.conv2"),
                "bn2": _bn_params(sd, f"{pre}.bn2"),
                "conv3_w": _conv_w(sd, f"{pre}.conv3"),
                "bn3": _bn_params(sd, f"{pre}.bn3"),
            }
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {
                    "conv_w": _conv_w(sd, f"{pre}.downsample.0"),
                    "bn": _bn_params(sd, f"{pre}.downsample.1"),
                }
            blocks.append(blk)
        params[f"layer{li}"] = blocks
    ap = "visual.attnpool"
    embed_dim = sd[f"{ap}.k_proj.weight"].shape[1]
    heads = embed_dim * 1 // 64  # vision_heads = width * 32 / 64 (clip/model.py:331)
    params["attnpool"] = {
        "positional_embedding": sd[f"{ap}.positional_embedding"],
        **{
            name: {"w": sd[f"{ap}.{name}.weight"].T.copy(), "b": sd[f"{ap}.{name}.bias"]}
            for name in ("q_proj", "k_proj", "v_proj", "c_proj")
        },
    }
    return params, layers, heads
