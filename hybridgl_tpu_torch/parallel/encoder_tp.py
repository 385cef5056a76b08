"""Tensor-parallel SAM image encoder over the ``mp`` axis of a process mesh
(counterpart of hybridgl_tpu/parallel/encoder_tp.py).

Megatron-style sharding of the pipeline's heaviest single-image stage: each
block's attention shards by HEAD GROUPS (qkv column-sharded, output
projection row-sharded) and its MLP by the hidden dimension (fc
column-sharded, proj row-sharded), so one ``all_reduce`` per half-block is
the only collective. Residual adds and LayerNorms see the full, replicated
activations, which the sums re-materialise.

A rank's attention goes through the encoder's own ``_attention``
(``models/sam/image_encoder.py``) with ``heads // mp`` heads at the unchanged
head dim, so on a card it launches K1 (windowed blocks) and K2 (global blocks)
on its share of the heads. The output is replicated over the axis and matches
the single-process encoder up to the sums' order.

The encoder params are the list of blocks (the reference's stacked
``block_runs`` are an artefact of its scan). :func:`shard_encoder_params`
slices a rank's shard once; :func:`encode_image_tp` takes either that or the
full tree (and slices at the call).
"""

from __future__ import annotations

import torch

from ..core.config import SamConfig
from ..models.sam.image_encoder import (
    _attention,
    _ln,
    _mlp,
    embed_patches,
    neck,
    window_partition,
    window_unpartition,
)
from .mesh import ProcessMesh


def _shard_block_params(bp, cfg: SamConfig, idx: int, mp: int):
    """One block's params sliced to rank ``idx``'s head and hidden shards."""
    D = cfg.encoder_width
    H = cfg.encoder_heads
    assert H % mp == 0, (H, mp)
    dl = (H // mp) * (D // H)  # local attention width
    mlp_h = bp["mlp_fc"]["w"].shape[-1]
    assert mlp_h % mp == 0, (mlp_h, mp)
    ml = mlp_h // mp

    attn = bp["attn"]
    # qkv_w packs [q | k | v] along the output dim; take this shard's head
    # group from each section so the block's split-in-3 code works
    cols = torch.cat([torch.arange(s * D + idx * dl, s * D + (idx + 1) * dl) for s in range(3)]).to(attn["qkv_w"].device)
    zero = torch.zeros_like(attn["proj_b"])
    new_attn = {
        "qkv_w": attn["qkv_w"][..., cols].contiguous(),
        "qkv_b": attn["qkv_b"][..., cols].contiguous(),
        # row-shard the output projection; the bias is added on shard 0 only
        # so the sum reconstructs it exactly once
        "proj_w": attn["proj_w"][idx * dl : (idx + 1) * dl].contiguous(),
        "proj_b": attn["proj_b"] if idx == 0 else zero,
        "rel_pos_h": attn["rel_pos_h"],  # per-head-dim tables: shared
        "rel_pos_w": attn["rel_pos_w"],
    }
    for k in ("rel_tab_h", "rel_tab_w"):  # the precomputed [G, G, hd] tables: shared too
        if k in attn:
            new_attn[k] = attn[k]
    return {
        "ln_1": bp["ln_1"],
        "ln_2": bp["ln_2"],
        "attn": new_attn,
        "mlp_fc": {
            "w": bp["mlp_fc"]["w"][..., idx * ml : (idx + 1) * ml].contiguous(),
            "b": bp["mlp_fc"]["b"][..., idx * ml : (idx + 1) * ml].contiguous(),
        },
        "mlp_proj": {
            "w": bp["mlp_proj"]["w"][idx * ml : (idx + 1) * ml].contiguous(),
            "b": bp["mlp_proj"]["b"] if idx == 0 else torch.zeros_like(bp["mlp_proj"]["b"]),
        },
    }


def shard_encoder_params(p_enc, cfg: SamConfig, idx: int, mp: int):
    """The encoder tree with every block sliced to rank ``idx`` of ``mp``
    (patch embedding, position embedding and neck stay whole)."""
    out = dict(p_enc)
    out["blocks"] = [_shard_block_params(bp, cfg, idx, mp) for bp in p_enc["blocks"]]
    out["tp_shard"] = (idx, mp)
    return out


def _block_tp(bp_local, x, cfg: SamConfig, window: int, heads_local: int, mesh: ProcessMesh, axis: str):
    """``encoder_block`` with head- and hidden-sharded params: a sum over the
    axis after the attention projection and after the MLP projection."""
    shortcut = x
    y = _ln(bp_local["ln_1"], x)
    if window > 0:
        Hh, Ww = y.shape[1], y.shape[2]
        wins, pad_hw = window_partition(y, window)
        wins = _attention(bp_local["attn"], wins, heads_local, window)
        y = window_unpartition(wins, window, pad_hw, (Hh, Ww))
    else:
        y = _attention(bp_local["attn"], y, heads_local, y.shape[1])
    x = shortcut + mesh.all_reduce_sum(y, axis)
    return x + mesh.all_reduce_sum(_mlp(bp_local, _ln(bp_local["ln_2"], x)), axis)


@torch.no_grad()
def encode_image_tp(p_enc, images: torch.Tensor, cfg: SamConfig, mesh: ProcessMesh, axis: str = "mp"):
    """Tensor-parallel ``encode_image``: every rank of ``axis`` calls it with
    the same images and gets the same [N, g, g, prompt_dim] output."""
    mp, idx = mesh.size(axis), mesh.index(axis)
    if p_enc.get("tp_shard") is None:
        p_enc = shard_encoder_params(p_enc, cfg, idx, mp)
    elif p_enc["tp_shard"] != (idx, mp):
        raise ValueError(f"params sharded for {p_enc['tp_shard']}, this rank is {(idx, mp)}")
    heads_local = cfg.encoder_heads // mp
    x = embed_patches(p_enc, images, cfg)
    for i, bp in enumerate(p_enc["blocks"]):
        window = 0 if i in cfg.encoder_global_idx else cfg.window_size
        x = _block_tp(bp, x, cfg, window, heads_local, mesh, axis)
    return neck(p_enc, x)
