"""The CLIP block's fused glue (``hybridgl_tpu_torch/kernels/clip_glue.py``,
``csrc/clip_glue.cu``) on the CPU, where each operator runs its plain
version: each operator equal bit for bit to the sequence of PyTorch
operations the model code ran before the glue was fused (``layer_norm``,
``linear``, ``quick_gelu``, ``token_mask``, the head split and merge, written
out below), in bf16 and f32; the model paths that chain the operators (the
G2L forward, the chained blocks of the other fusion modes, the text tower:
each LayerNorm written by the kernel that writes the residual it normalises)
equal to the same paths as one block after another, each computing its own
LayerNorms; the row-stride reading of the LayerNorm operator; the launch
counters; and the kernels' device names, none of which may contain a
substring by which the benchmark's trace reader counts the port's own
kernels (``benchmark/benchlib/trace.py:OWN_KERNELS``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hybridgl_tpu_torch.core.config import clip_preset
from hybridgl_tpu_torch.core.params import cast_tree, init_clip
from hybridgl_tpu_torch.kernels import GLUE, kernel_wrappers, launch_counts, reset_launch_counts
from hybridgl_tpu_torch.kernels.clip_glue import _row_stride
from hybridgl_tpu_torch.models.clip.fusion import (
    hybrid_forward,
    last_layer_index,
    make_cls_bias,
    resize_masks_to_grid,
    token_mask,
)
from hybridgl_tpu_torch.models.clip.layers import layer_norm, residual_attention_block
from hybridgl_tpu_torch.models.clip.text import causal_bias, encode_text
from hybridgl_tpu_torch.models.clip.vit import encode_image, vit_block, vit_head, vit_stem

REPO = Path(__file__).resolve().parent.parent
OPS = torch.ops.hybridgl
DTYPES = [torch.bfloat16, torch.float32]


def _t(rng, *shape, dtype=torch.float32, std=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32)).to(dtype)


def _ln(rng, D, dtype):
    return {"scale": _t(rng, D, std=0.1, mean=1.0, dtype=dtype), "bias": _t(rng, D, std=0.1, dtype=dtype)}


def _lin(rng, d_in, d_out, dtype):
    return {"w": _t(rng, d_in, d_out, std=d_in**-0.5, dtype=dtype), "b": _t(rng, d_out, std=0.5, dtype=dtype)}


class plain:
    """The glue as the model code wrote it before it was fused, one PyTorch operation at a time."""

    @staticmethod
    def layer_norm(p, x, eps: float = 1e-5):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)

    @staticmethod
    def linear(p, x):
        return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)

    @staticmethod
    def quick_gelu(x):
        return x * torch.sigmoid(1.702 * x)

    @staticmethod
    def token_mask(x, masks_grid):
        m = masks_grid.reshape(x.shape[0], -1, 1).to(x.dtype)
        return torch.cat([x[:, :1, :], x[:, 1:, :] * m], dim=1)


def todays_and_fused(name, dtype, N=3, L=9, D=32, H=4, seed=0):
    """(the operator's outputs, today's sequence's outputs) on the same inputs."""
    rng = np.random.default_rng(seed)
    x, x2, a = (_t(rng, N, L, D, dtype=dtype) for _ in range(3))
    ln = _ln(rng, D, dtype)
    if name == "layer_norm":
        x = x * 3.0 + 1.5  # a mean and a scale away from the LayerNorm's output
        return OPS.layer_norm(x, ln["scale"], ln["bias"], 1e-5), plain.layer_norm(ln, x)
    if name in ("residual_add", "residual_layer_norm"):
        p = _lin(rng, D, D, dtype)
        y = a @ p["w"]
        x_new = x + plain.linear(p, a)
        if name == "residual_add":
            return OPS.residual_add(x, y, p["b"]), x_new
        return OPS.residual_layer_norm(x, y, p["b"], ln["scale"], ln["bias"], 1e-5), (x_new, plain.layer_norm(ln, x_new))
    if name == "inject_layer_norm":
        m = torch.from_numpy(rng.random((N, L - 1)).astype(np.float32))
        m[m < 0.3] = 0.0  # empty patches beside fractional ones
        x_new = 2.0 * plain.token_mask(x2, m) + x
        return OPS.inject_layer_norm(x, x2, m, ln["scale"], ln["bias"], 1e-5), (x_new, plain.layer_norm(ln, x_new))
    if name == "qkv_heads":
        p = _lin(rng, D, 3 * D, dtype)
        qkv = plain.linear(p, a)
        hd = D // H
        heads = [t.reshape(N, L, H, hd).transpose(1, 2).reshape(N * H, L, hd).contiguous() for t in qkv.split(D, dim=-1)]
        return OPS.qkv_heads(a @ p["w"], p["b"], H), tuple(heads)
    if name == "merge_heads":
        ctx = _t(rng, N * H, L, D // H, dtype=dtype)
        return OPS.merge_heads(ctx, N), ctx.reshape(N, H, L, D // H).transpose(1, 2).reshape(N, L, D)
    assert name == "bias_quick_gelu"
    p = _lin(rng, D, 4 * D, dtype)
    return OPS.bias_quick_gelu(a @ p["w"], p["b"]), plain.quick_gelu(plain.linear(p, a))


def flat(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("name", GLUE)
def test_operator_equals_todays_sequence(name, dtype):
    got, want = todays_and_fused(name, dtype)
    for g, w in zip(flat(got), flat(want), strict=True):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape and torch.equal(g, w)


def _clip(dtype, seed=1):
    cfg = clip_preset("test-tiny")
    return cfg, cast_tree(init_clip(torch.Generator().manual_seed(seed), cfg), dtype)


def _crops(cfg, P, seed=2):
    rng = np.random.default_rng(seed)
    S = cfg.image_size
    local, glob = (_t(rng, P, S, S, 3) for _ in range(2))
    masks = torch.from_numpy((rng.random((P, S, S)) > 0.5).astype(np.float32))
    masks[1] = 0.0  # an empty proposal
    return local, glob, masks


@pytest.mark.parametrize("masking_block", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_g2l_forward_equals_todays_sequence(dtype, masking_block):
    """The main path's mode: the trunk's chained LayerNorms, the injection
    kernel and the global stream's handed-over ln_1 change no bit against
    G2L written block by block (backbone.py:227-260)."""
    cfg, params = _clip(dtype)
    local, glob, masks = _crops(cfg, 4)
    p, blocks, P = params["visual"], params["visual"]["blocks"], local.shape[0]
    got = hybrid_forward(p, local, glob, masks, cfg, fusion_mode="G2L", masking_block=masking_block)
    grid = resize_masks_to_grid(masks, cfg.grid, None)
    bias = make_cls_bias(grid)
    xx = torch.cat([vit_stem(p, local, cfg), vit_stem(p, glob, cfg)], dim=0)
    for i in range(masking_block):
        xx = vit_block(blocks[i], xx, cfg)
    x, x2 = xx[:P], xx[P:]
    for i in range(masking_block, last_layer_index(cfg) + 2):
        x, x2 = vit_block(blocks[i], 2.0 * token_mask(x2, grid) + x, cfg), vit_block(blocks[i], x2, cfg, cls_bias=bias)
    want = vit_head(p, x, cfg)
    assert got.dtype == want.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_chained_vision_blocks_equal_todays_sequence(dtype):
    """encode_image (the crop mode's path): every block hands the next its
    ln_1, the last writes the residual alone."""
    cfg, params = _clip(dtype, seed=3)
    local, _, _ = _crops(cfg, 3, seed=4)
    p = params["visual"]
    x = vit_stem(p, local, cfg)
    for blk in p["blocks"]:
        x = vit_block(blk, x, cfg)
    assert torch.equal(encode_image(p, local, cfg), vit_head(p, x, cfg))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_text_tower_equals_todays_sequence(dtype):
    """The causal-bias route: the plain attention, the fused residuals and
    LayerNorms, ln_final from the last block's kernel."""
    cfg, params = _clip(dtype, seed=5)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (5, cfg.context_length)).astype(np.int32))
    p = params["text"]
    emb = p["token_embedding"]
    x = emb[tokens.long().clamp(max=emb.shape[0] - 1)] + p["positional_embedding"].to(emb.dtype)
    for blk in p["blocks"]:
        x = residual_attention_block(blk, x, cfg.text_heads, causal_bias(cfg.context_length))
    x = layer_norm(p["ln_final"], x)[torch.arange(x.shape[0]), tokens.argmax(dim=-1)]
    want = (x @ p["text_projection"].to(x.dtype)).float()
    assert torch.equal(encode_text(p, tokens, cfg), want)


def _global_kernels(source: str) -> dict:
    """{kernel name: its signature up to the parameter list's end} of every ``__global__`` function."""
    out = {}
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(([^)]*)\)", source):
        out[m.group(1)] = m.group(0)
    return out


def test_glue_kernel_names_miss_the_benchmarks_own_kernel_substrings():
    """The benchmark counts the port's own kernels in a trace by substrings of
    their device names; a glue kernel matching one would be counted as
    another kernel's launch and silence ``kernels_roofline``."""
    from benchmark.benchlib.trace import OWN_KERNELS

    kernels = _global_kernels((REPO / "hybridgl_tpu_torch" / "csrc" / "clip_glue.cu").read_text())
    assert set(kernels) == {"clip_glue_rows", "clip_glue_qkv_heads", "clip_glue_merge", "clip_glue_bias_gelu"}
    for name, signature in kernels.items():
        for key, label in OWN_KERNELS:
            assert key not in name and key not in signature, (name, label)


@pytest.mark.parametrize("view,stride", [
    (lambda x: x, 16),                      # [4, 6, 16] contiguous
    (lambda x: x[:, 0, :], 6 * 16),         # the CLS rows (vit_head)
    (lambda x: x[:, :1], 6 * 16),           # [4, 1, 16] (GEM's CLS rows)
    (lambda x: x[:1, :1], 16),              # one row
    (lambda x: x[..., :8], 16),             # rows cut short, still one stride apart
    (lambda x: x[:, 1:, :], None),          # two strides
    (lambda x: x.transpose(1, 2), None),    # columns
], ids=["contiguous", "cls_rows", "cls_rows_3d", "one_row", "narrowed", "patch_rows", "transposed"])
def test_layer_norm_reads_rows_at_one_stride(view, stride):
    """The LayerNorm kernel reads row r at r * stride: views with one stride
    between their rows take it; on the card the others raise."""
    assert _row_stride(view(torch.zeros(4, 6, 16))) == stride


def test_glue_wrappers_count_launches_and_fallbacks():
    """Each glue wrapper is a kernel wrapper with a launch counter, reset
    with the others; a CPU call runs the plain version and counts nothing
    (on a CUDA tensor a wrapper launches or raises: no plain fallback)."""
    wrappers = kernel_wrappers()
    assert set(GLUE) <= set(wrappers)
    for name in GLUE:
        wrappers[name].launches = 3
        assert not hasattr(wrappers[name], "fallbacks")
    reset_launch_counts()
    assert not any(launch_counts().values())
    for name in GLUE:
        todays_and_fused(name, torch.bfloat16)
    assert not any(launch_counts().values())
