"""Published torch checkpoints -> the port's parameter trees (port of hybridgl_tpu/core/convert.py).

SAM ships as a segment-anything ``.pth`` state dict (build_sam.py:103-107),
CLIP as OpenAI's JIT archive or a state dict (clip/clip.py:94-194). Both are
converted into the layout of ``core/params.py`` (input-major weight matrices,
HWIO convolution kernels) as trees of numpy leaves, which
``core/params.py:from_numpy_tree`` puts on the device and
``core/checkpoint.py:save`` stores as ``.npz``. The trees equal the JAX
package's converter's key for key and value for value, so a converted
``.npz`` serves both packages.

All functions take a ``{name: numpy array}`` state dict; only the thin
``load_torch_*`` helpers read files.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from .config import ClipConfig, SamConfig

Array = np.ndarray
StateDict = Dict[str, Array]


def _np(t) -> Array:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()  # torch tensor


def _ln(sd: StateDict, prefix: str):
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _linear_t(sd: StateDict, prefix: str):
    """torch Linear ([out,in]) -> input-major {'w': [in,out], 'b': [out]}."""
    return {"w": sd[f"{prefix}.weight"].T.copy(), "b": sd[f"{prefix}.bias"]}


def normalize_state_dict(sd) -> StateDict:
    return {k: _np(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def infer_clip_config(sd: StateDict) -> ClipConfig:
    """Shape-driven config inference (mirrors the semantics of the
    reference's build_model, clip/model.py:474-497; ViT checkpoints only)."""
    if "visual.proj" not in sd:
        raise ValueError("only ViT CLIP checkpoints are supported (no 'visual.proj' in the state dict)")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len(
        [k for k in sd if re.fullmatch(r"visual\.transformer\.resblocks\.\d+\.attn\.in_proj_weight", k)]
    )
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    tw = sd["ln_final.weight"].shape[0]
    return ClipConfig(
        image_size=patch * grid,
        patch_size=patch,
        vision_width=vision_width,
        vision_layers=vision_layers,
        vision_heads=vision_width // 64,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=tw,
        text_heads=tw // 64,
        text_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}
        ),
        embed_dim=sd["text_projection"].shape[1],
    )


def _clip_resblock(sd: StateDict, prefix: str):
    return {
        "ln_1": _ln(sd, f"{prefix}.ln_1"),
        "attn": {
            "in_proj_w": sd[f"{prefix}.attn.in_proj_weight"].T.copy(),
            "in_proj_b": sd[f"{prefix}.attn.in_proj_bias"],
            "out_w": sd[f"{prefix}.attn.out_proj.weight"].T.copy(),
            "out_b": sd[f"{prefix}.attn.out_proj.bias"],
        },
        "ln_2": _ln(sd, f"{prefix}.ln_2"),
        "mlp_fc": _linear_t(sd, f"{prefix}.mlp.c_fc"),
        "mlp_proj": _linear_t(sd, f"{prefix}.mlp.c_proj"),
    }


def convert_clip(sd, cfg: ClipConfig | None = None):
    """OpenAI-CLIP state dict -> the parameter tree (numpy leaves)."""
    sd = normalize_state_dict(sd)
    cfg = cfg or infer_clip_config(sd)
    visual = {
        # torch conv [out, in, kh, kw] -> HWIO
        "conv1": sd["visual.conv1.weight"].transpose(2, 3, 1, 0).copy(),
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "blocks": [
            _clip_resblock(sd, f"visual.transformer.resblocks.{i}")
            for i in range(cfg.vision_layers)
        ],
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": sd["visual.proj"],
    }
    text = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "blocks": [
            _clip_resblock(sd, f"transformer.resblocks.{i}")
            for i in range(cfg.text_layers)
        ],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }
    return {"visual": visual, "text": text, "logit_scale": sd["logit_scale"].reshape(())}


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------


def infer_sam_config(sd: StateDict) -> SamConfig:
    depth = len(
        {
            int(m.group(1))
            for k in sd
            if (m := re.match(r"image_encoder\.blocks\.(\d+)\.", k))
        }
    )
    width = sd["image_encoder.patch_embed.proj.weight"].shape[0]
    presets = {
        (12, 768): dict(encoder_global_idx=(2, 5, 8, 11), encoder_heads=12),
        (24, 1024): dict(encoder_global_idx=(5, 11, 17, 23), encoder_heads=16),
        (32, 1280): dict(encoder_global_idx=(7, 15, 23, 31), encoder_heads=16),
    }
    extra = presets[(depth, width)]
    return SamConfig(encoder_width=width, encoder_depth=depth, **extra)


def _sam_enc_block(sd: StateDict, prefix: str):
    return {
        "ln_1": _ln(sd, f"{prefix}.norm1"),
        "attn": {
            "qkv_w": sd[f"{prefix}.attn.qkv.weight"].T.copy(),
            "qkv_b": sd[f"{prefix}.attn.qkv.bias"],
            "proj_w": sd[f"{prefix}.attn.proj.weight"].T.copy(),
            "proj_b": sd[f"{prefix}.attn.proj.bias"],
            "rel_pos_h": sd[f"{prefix}.attn.rel_pos_h"],
            "rel_pos_w": sd[f"{prefix}.attn.rel_pos_w"],
        },
        "ln_2": _ln(sd, f"{prefix}.norm2"),
        "mlp_fc": _linear_t(sd, f"{prefix}.mlp.lin1"),
        "mlp_proj": _linear_t(sd, f"{prefix}.mlp.lin2"),
    }


def _twoway_attn(sd: StateDict, prefix: str):
    return {
        "q": _linear_t(sd, f"{prefix}.q_proj"),
        "k": _linear_t(sd, f"{prefix}.k_proj"),
        "v": _linear_t(sd, f"{prefix}.v_proj"),
        "out": _linear_t(sd, f"{prefix}.out_proj"),
    }


def _twoway_block(sd: StateDict, prefix: str):
    return {
        "self_attn": _twoway_attn(sd, f"{prefix}.self_attn"),
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "cross_t2i": _twoway_attn(sd, f"{prefix}.cross_attn_token_to_image"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
        "mlp_fc": _linear_t(sd, f"{prefix}.mlp.lin1"),
        "mlp_proj": _linear_t(sd, f"{prefix}.mlp.lin2"),
        "norm3": _ln(sd, f"{prefix}.norm3"),
        "norm4": _ln(sd, f"{prefix}.norm4"),
        "cross_i2t": _twoway_attn(sd, f"{prefix}.cross_attn_image_to_token"),
    }


def _conv(sd: StateDict, prefix: str, bias=True):
    out = {"w": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0).copy()}
    if bias:
        out["b"] = sd[f"{prefix}.bias"]
    return out


def convert_sam(sd, cfg: SamConfig | None = None):
    """segment-anything ``.pth`` state dict -> the parameter tree (numpy leaves)."""
    sd = normalize_state_dict(sd)
    cfg = cfg or infer_sam_config(sd)
    enc = "image_encoder"
    encoder = {
        "patch_embed": _conv(sd, f"{enc}.patch_embed.proj"),
        "pos_embed": sd[f"{enc}.pos_embed"],
        "blocks": [
            _sam_enc_block(sd, f"{enc}.blocks.{i}") for i in range(cfg.encoder_depth)
        ],
        "neck": {
            "conv1_w": sd[f"{enc}.neck.0.weight"].transpose(2, 3, 1, 0).copy(),
            "ln1": _ln(sd, f"{enc}.neck.1"),
            "conv2_w": sd[f"{enc}.neck.2.weight"].transpose(2, 3, 1, 0).copy(),
            "ln2": _ln(sd, f"{enc}.neck.3"),
        },
    }
    pe = "prompt_encoder"
    prompt = {
        "pe_gaussian": sd[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"],
        "point_embeddings": np.stack(
            [sd[f"{pe}.point_embeddings.{i}.weight"][0] for i in range(4)]
        ),
        "not_a_point_embed": sd[f"{pe}.not_a_point_embed.weight"][0],
        "no_mask_embed": sd[f"{pe}.no_mask_embed.weight"][0],
        "mask_downscaling": {
            "conv1": _conv(sd, f"{pe}.mask_downscaling.0"),
            "ln1": _ln(sd, f"{pe}.mask_downscaling.1"),
            "conv2": _conv(sd, f"{pe}.mask_downscaling.3"),
            "ln2": _ln(sd, f"{pe}.mask_downscaling.4"),
            "conv3": _conv(sd, f"{pe}.mask_downscaling.6"),
        },
    }
    de = "mask_decoder"
    nmt = sd[f"{de}.mask_tokens.weight"].shape[0]
    decoder = {
        "iou_token": sd[f"{de}.iou_token.weight"],
        "mask_tokens": sd[f"{de}.mask_tokens.weight"],
        "transformer": {
            "layers": [
                _twoway_block(sd, f"{de}.transformer.layers.{i}")
                for i in range(cfg.decoder_depth)
            ],
            "final_attn": _twoway_attn(sd, f"{de}.transformer.final_attn_token_to_image"),
            "norm_final": _ln(sd, f"{de}.transformer.norm_final_attn"),
        },
        "upscale": {
            # torch ConvTranspose2d [in, out, kh, kw] -> HWIO [kh, kw, in, out]
            "deconv1": {
                "w": sd[f"{de}.output_upscaling.0.weight"].transpose(2, 3, 0, 1).copy(),
                "b": sd[f"{de}.output_upscaling.0.bias"],
            },
            "ln": _ln(sd, f"{de}.output_upscaling.1"),
            "deconv2": {
                "w": sd[f"{de}.output_upscaling.3.weight"].transpose(2, 3, 0, 1).copy(),
                "b": sd[f"{de}.output_upscaling.3.bias"],
            },
        },
        "hyper_mlps": [
            [
                _linear_t(sd, f"{de}.output_hypernetworks_mlps.{i}.layers.{j}")
                for j in range(3)
            ]
            for i in range(nmt)
        ],
        "iou_head": [
            _linear_t(sd, f"{de}.iou_prediction_head.layers.{j}") for j in range(3)
        ],
    }
    return {"encoder": encoder, "prompt": prompt, "decoder": decoder}


# ---------------------------------------------------------------------------
# file loaders
# ---------------------------------------------------------------------------


def load_torch_clip(path: str, cfg: ClipConfig | None = None):
    """Load an OpenAI CLIP checkpoint (.pt JIT archive or state dict) -> (tree, config).
    The config is inferred from the shapes unless the caller names one (the
    inference assumes 64-wide heads, which the test-tiny preset does not have)."""
    import torch

    try:
        import warnings

        with warnings.catch_warnings():
            # OpenAI CLIP ships TorchScript archives: torch.jit.load IS
            # the loader for them (torch.export cannot read legacy
            # torchscript), so its deprecation warning is noise here
            warnings.filterwarnings("ignore", category=DeprecationWarning)
            model = torch.jit.load(path, map_location="cpu")
        sd = model.state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu")
    sd = {k: v for k, v in sd.items() if not k.startswith("input_resolution")}
    for key in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(key, None)
    cfg = cfg or infer_clip_config(normalize_state_dict(sd))
    return convert_clip(sd, cfg), cfg


def load_torch_sam(path: str, cfg: SamConfig | None = None):
    """Load a segment-anything ``.pth`` -> (tree, config); the config is inferred
    (vit_b, vit_l or vit_h by depth and width) unless the caller names one."""
    import torch

    sd = torch.load(path, map_location="cpu")
    cfg = cfg or infer_sam_config(normalize_state_dict(sd))
    return convert_sam(sd, cfg), cfg
