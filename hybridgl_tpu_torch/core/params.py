"""Parameter trees for the port: random init, numpy import, dtype casts.

The trees have exactly the keys and shapes of the reference's
(``hybridgl_tpu/core/params.py``: ``init_clip`` :66, ``init_sam`` :157):
nested dicts and lists whose leaves are tensors, weight matrices stored
input-major ([D_in, D_out]) so forward passes are plain ``x @ w``, and
convolution kernels stored HWIO. ``from_numpy_tree`` therefore takes the
reference's parameters (leaves converted to numpy) unchanged, and the same
weights feed both packages.

Random init draws from a ``torch.Generator`` on the generator's device, so a
full-width ViT-H tree is made on the card without a host round trip. The
numbers differ from ``jax.random`` for the same seed; tests that compare the
packages build their weights once and convert.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..core.config import ClipConfig, SamConfig


class _Init:
    """Normal draws from one generator, on its device, in f32."""

    def __init__(self, generator: torch.Generator):
        self.g = generator
        self.device = generator.device

    def normal(self, shape, std=1.0) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.device) * std

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device)


def _ln(r: _Init, d):
    return {"scale": r.ones((d,)), "bias": r.zeros((d,))}


def _linear(r: _Init, d_in, d_out, std=None):
    std = std if std is not None else d_in**-0.5
    return {"w": r.normal((d_in, d_out), std), "b": r.zeros((d_out,))}


def _attn(r: _Init, d):
    return {
        "in_proj_w": r.normal((d, 3 * d), d**-0.5),
        "in_proj_b": r.zeros((3 * d,)),
        "out_w": r.normal((d, d), d**-0.5),
        "out_b": r.zeros((d,)),
    }


def _resblock(r: _Init, d):
    return {
        "ln_1": _ln(r, d),
        "attn": _attn(r, d),
        "ln_2": _ln(r, d),
        "mlp_fc": _linear(r, d, 4 * d),
        "mlp_proj": _linear(r, 4 * d, d),
    }


def init_clip(generator: torch.Generator, cfg: ClipConfig):
    r = _Init(generator)
    vw, tw = cfg.vision_width, cfg.text_width
    visual = {
        "conv1": r.normal((cfg.patch_size, cfg.patch_size, 3, vw), vw**-0.5),
        "class_embedding": r.normal((vw,), vw**-0.5),
        "positional_embedding": r.normal((cfg.seq_len, vw), vw**-0.5),
        "ln_pre": _ln(r, vw),
        "blocks": [_resblock(r, vw) for _ in range(cfg.vision_layers)],
        "ln_post": _ln(r, vw),
        "proj": r.normal((vw, cfg.embed_dim), vw**-0.5),
    }
    text = {
        "token_embedding": r.normal((cfg.vocab_size, tw), 0.02),
        "positional_embedding": r.normal((cfg.context_length, tw), 0.01),
        "blocks": [_resblock(r, tw) for _ in range(cfg.text_layers)],
        "ln_final": _ln(r, tw),
        "text_projection": r.normal((tw, cfg.embed_dim), tw**-0.5),
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32, device=r.device),
    }


def _sam_enc_block(r: _Init, cfg: SamConfig, window: int):
    d = cfg.encoder_width
    hd = d // cfg.encoder_heads
    size = window if window > 0 else cfg.embed_grid
    return {
        "ln_1": _ln(r, d),
        "attn": {
            "qkv_w": r.normal((d, 3 * d), d**-0.5),
            "qkv_b": r.zeros((3 * d,)),
            "proj_w": r.normal((d, d), d**-0.5),
            "proj_b": r.zeros((d,)),
            "rel_pos_h": r.zeros((2 * size - 1, hd)),
            "rel_pos_w": r.zeros((2 * size - 1, hd)),
        },
        "ln_2": _ln(r, d),
        "mlp_fc": _linear(r, d, int(d * cfg.mlp_ratio)),
        "mlp_proj": _linear(r, int(d * cfg.mlp_ratio), d),
    }


def _mlp_stack(r: _Init, dims):
    return [_linear(r, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def _twoway_attn(r: _Init, d, downsample=1):
    di = d // downsample
    return {
        "q": _linear(r, d, di),
        "k": _linear(r, d, di),
        "v": _linear(r, d, di),
        "out": _linear(r, di, d),
    }


def _twoway_block(r: _Init, cfg: SamConfig):
    d = cfg.prompt_dim
    return {
        "self_attn": _twoway_attn(r, d),
        "norm1": _ln(r, d),
        "cross_t2i": _twoway_attn(r, d, 2),
        "norm2": _ln(r, d),
        "mlp_fc": _linear(r, d, cfg.decoder_mlp_dim),
        "mlp_proj": _linear(r, cfg.decoder_mlp_dim, d),
        "norm3": _ln(r, d),
        "norm4": _ln(r, d),
        "cross_i2t": _twoway_attn(r, d, 2),
    }


def init_sam(generator: torch.Generator, cfg: SamConfig):
    r = _Init(generator)
    d = cfg.encoder_width
    pd = cfg.prompt_dim
    g = cfg.embed_grid
    mic = cfg.mask_in_chans
    encoder = {
        "patch_embed": {
            "w": r.normal((cfg.patch_size, cfg.patch_size, 3, d), d**-0.5),
            "b": r.zeros((d,)),
        },
        "pos_embed": r.zeros((1, g, g, d)),
        "blocks": [
            _sam_enc_block(r, cfg, 0 if i in cfg.encoder_global_idx else cfg.window_size)
            for i in range(cfg.encoder_depth)
        ],
        "neck": {
            "conv1_w": r.normal((1, 1, d, pd), d**-0.5),
            "ln1": _ln(r, pd),
            "conv2_w": r.normal((3, 3, pd, pd), (9 * pd) ** -0.5),
            "ln2": _ln(r, pd),
        },
    }
    prompt = {
        "pe_gaussian": r.normal((2, pd // 2)),
        "point_embeddings": r.normal((4, pd)),
        "not_a_point_embed": r.normal((pd,)),
        "no_mask_embed": r.normal((pd,)),
        "mask_downscaling": {
            "conv1": {"w": r.normal((2, 2, 1, mic // 4)), "b": r.zeros((mic // 4,))},
            "ln1": _ln(r, mic // 4),
            "conv2": {"w": r.normal((2, 2, mic // 4, mic)), "b": r.zeros((mic,))},
            "ln2": _ln(r, mic),
            "conv3": {"w": r.normal((1, 1, mic, pd)), "b": r.zeros((pd,))},
        },
    }
    nmt = cfg.num_mask_tokens
    decoder = {
        "iou_token": r.normal((1, pd)),
        "mask_tokens": r.normal((nmt, pd)),
        "transformer": {
            "layers": [_twoway_block(r, cfg) for _ in range(cfg.decoder_depth)],
            "final_attn": _twoway_attn(r, pd, 2),
            "norm_final": _ln(r, pd),
        },
        "upscale": {
            # ConvTranspose2d kernels stored HWIO ([kh, kw, in, out])
            "deconv1": {"w": r.normal((2, 2, pd, pd // 4), pd**-0.5), "b": r.zeros((pd // 4,))},
            "ln": _ln(r, pd // 4),
            "deconv2": {
                "w": r.normal((2, 2, pd // 4, pd // 8), pd**-0.5),
                "b": r.zeros((pd // 8,)),
            },
        },
        "hyper_mlps": [_mlp_stack(r, [pd, pd, pd, pd // 8]) for _ in range(nmt)],
        "iou_head": _mlp_stack(
            r, [pd] + [cfg.iou_head_hidden] * (cfg.iou_head_depth - 1) + [nmt]
        ),
    }
    return {"encoder": encoder, "prompt": prompt, "decoder": decoder}


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------


def tree_map(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` to every leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> Iterator:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def cast_tree(tree, dtype: torch.dtype):
    """Cast floating leaves to ``dtype`` (bf16 for serving). ``logit_scale``
    stays f32, as the reference's serving setup keeps it (bench.py:326)."""

    def cast(path, x):
        if path and path[-1] == "logit_scale":
            return x
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)


def from_numpy_tree(tree, device="cpu", dtype: torch.dtype | None = None):
    """The reference's parameter tree (list-of-blocks format, numpy leaves)
    -> the port's (tensor leaves on ``device``; floating leaves cast to
    ``dtype`` when given)."""
    out = tree_map(
        lambda _, x: torch.from_numpy(np.array(x, copy=True)).to(device), tree
    )
    return cast_tree(out, dtype) if dtype is not None else out


def load_npz(path: str):
    """A parameter tree saved by the reference's ``core/checkpoint.save`` as
    ``.npz`` (keys are '/'-joined paths, list indices as digits) -> nested
    dicts and lists of numpy leaves, for :func:`from_numpy_tree`."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    root: dict = {}
    for key, val in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def param_count(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))
