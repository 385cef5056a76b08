"""Decomposed relative-position attention for the SAM image encoder (K1, K2, K9).

The three wrappers share one C entry point. For bf16 operands with head dim
64 or 80 it launches the tensor-core kernels of ``csrc/attention_wgmma.cu``:
the stream kernel where G = 64 (K2, K9), the resident kernel where S <= 256
(K1). f32 operands, the other head dims (8, 16, 32) and every other bf16
geometry run the CUDA-core kernel of ``csrc/attention.cu`` (REL_POS mode),
which is exact in f32. The dispatch is by dtype and shape alone, inside the C
entry point:

  * :func:`flash_windowed_fused` replaces the Pallas kernel of the same name
    (``hybridgl_tpu/kernels/flash_attention.py:276``): the 28 windowed ViT-H
    blocks, 25 windows x 16 heads of S = 196 tokens, G = 14;
  * :func:`flash_attention_fused` replaces the Pallas kernel of the same name
    (``hybridgl_tpu/kernels/flash_attention.py:171``): the 4 global blocks,
    16 heads of S = 4096 tokens, G = 64. The [S, S] score matrix never
    reaches device memory;
  * :func:`flash_attention_rel_pos` replaces the Pallas kernel of the same
    name (``hybridgl_tpu/kernels/flash_attention.py:78``): the same math on a
    pre-scaled q, with the reference's tiling arguments. No serving path
    calls it; the kernel check (``tools/check_kernels.py``) does.

Math (reference: segment_anything image_encoder.py:325-361):

  out = softmax(scale * q k^T + bias) v,  bias[q, k] = rel_h[q, k // G] + rel_w[q, k % G]

Inputs are q, k, v [BH, S, hd] (bf16 or f32, unscaled q) and the two rank-G
terms rel_h, rel_w [BH, S, G] in f32; the output is [BH, S, hd] in q's dtype.
Each wrapper calls its operator, ``torch.ops.hybridgl.<name>`` (``_ops.py``):
on a CPU tensor it runs :func:`reference_attention_rel_pos`, the plain
PyTorch version of the same function; on a CUDA tensor it launches the
kernel or raises. What bounds the kernels on the card, and their design, are
described in the CUDA sources. The tensor-core kernels round the scaled q and
the probabilities to bf16 (the latter is where the Pallas kernels round them
too); the bias and all sums stay in f32.
"""

from __future__ import annotations

import torch

from . import _build, _ops

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 80)
MAX_GRID_SIDE = 64


def reference_attention_rel_pos(q, k, v, rel_h, rel_w, grid_side: int, scale: float):
    """Plain PyTorch version of K1/K2: the [BH, S, S] scores materialised in f32."""
    BH, S, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    bias = (rel_h.float()[:, :, :, None] + rel_w.float()[:, :, None, :]).reshape(BH, S, S)
    p = torch.softmax(s + bias, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _check(name, q, k, v, rel_h, rel_w, grid_side):
    BH, S, hd = q.shape
    G = grid_side
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v shapes differ {q.shape} {k.shape} {v.shape}")
    if S != G * G:
        raise ValueError(f"{name}: S={S} is not grid_side**2 ({G}**2)")
    if rel_h.shape != (BH, S, G) or rel_w.shape != (BH, S, G):
        raise ValueError(f"{name}: rel terms must be [{BH}, {S}, {G}], got {rel_h.shape} {rel_w.shape}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share dtype bf16 or f32, got {q.dtype} {k.dtype} {v.dtype}")
    if rel_h.dtype != torch.float32 or rel_w.dtype != torch.float32:
        raise TypeError(f"{name}: rel terms must be f32 (the bias is kept in f32)")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if G > MAX_GRID_SIDE:
        raise ValueError(f"{name}: grid side {G} > {MAX_GRID_SIDE}")
    for t in (q, k, v, rel_h, rel_w):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned (the kernels load 16 bytes a thread)")


def _rel_pos_launch(wrapper, q, k, v, rel_h, rel_w, grid_side, scale):
    """The CUDA implementation of K1, K2 and K9: check, launch, count on ``wrapper``."""
    _check(wrapper.__name__, q, k, v, rel_h, rel_w, grid_side)
    BH, S, hd = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    tc = q.dtype == torch.bfloat16 and bool(lib.hgl_rel_pos_tc_takes(S, hd, grid_side))  # the C dispatch's own test
    code = lib.hgl_rel_pos_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
        out.data_ptr(), BH, S, hd, grid_side, float(scale),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device),
    )
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    wrapper.tc_launches += int(tc)
    return out


def _like_q(q, *_):
    return torch.empty_like(q)


_SCHEMA = "(Tensor q, Tensor k, Tensor v, Tensor rel_h, Tensor rel_w, int grid_side, float scale) -> Tensor"
_k1 = _ops.define("flash_windowed_fused" + _SCHEMA, reference_attention_rel_pos,
                  lambda *a: _rel_pos_launch(flash_windowed_fused, *a), _like_q)
_k2 = _ops.define("flash_attention_fused" + _SCHEMA, reference_attention_rel_pos,
                  lambda *a: _rel_pos_launch(flash_attention_fused, *a), _like_q)
_k9 = _ops.define(
    "flash_attention_rel_pos(Tensor q, Tensor k, Tensor v, Tensor rel_h, Tensor rel_w, int grid_side) -> Tensor",
    lambda q, k, v, rel_h, rel_w, grid_side: reference_attention_rel_pos(q, k, v, rel_h, rel_w, grid_side, 1.0),
    lambda *a: _rel_pos_launch(flash_attention_rel_pos, *a, 1.0), _like_q)


def flash_windowed_fused(q, k, v, rel_h, rel_w, grid_side: int, scale: float):
    """K1: whole-window rel-pos attention for the windowed encoder blocks
    (``torch.ops.hybridgl.flash_windowed_fused``)."""
    return _k1(q, k, v, rel_h, rel_w, int(grid_side), float(scale))


def flash_attention_fused(q, k, v, rel_h, rel_w, grid_side: int, scale: float):
    """K2: tiled online-softmax rel-pos attention for the global encoder blocks
    (``torch.ops.hybridgl.flash_attention_fused``)."""
    return _k2(q, k, v, rel_h, rel_w, int(grid_side), float(scale))


def flash_attention_rel_pos(q, k, v, rel_h, rel_w, grid_side: int, block_q: int = 256, block_k: int = 512):
    """K9: rel-pos attention on a q already scaled by 1/sqrt(hd).

    q, k, v [BH, S, hd] (bf16 or f32), rel_h, rel_w [BH, S, G] in any float
    dtype (widened to f32, as the reference does inside its kernel); the
    output is in q's dtype. ``block_q`` and ``block_k`` are the TPU kernel's
    tiles: they do not change the result and are only checked as the
    reference asserts them (S == G**2, S % block_q == 0, S % block_k == 0,
    block_k % G == 0). The CUDA kernels tile by 64 whatever they are. In
    bf16 at hd 64 or 80 the probabilities are rounded to v's dtype before the
    PV product, as the reference does; the f32 kernel keeps them in f32 (in
    f32 the two agree exactly)."""
    BH, S, _ = q.shape
    G = grid_side
    if S != G * G:
        raise ValueError(f"flash_attention_rel_pos: S={S} is not grid_side**2 ({G}**2)")
    if block_q < 1 or block_k < 1 or S % block_q or S % block_k:
        raise ValueError(f"flash_attention_rel_pos: S={S} must be a multiple of block_q={block_q} and block_k={block_k}")
    if block_k % G:
        raise ValueError(f"flash_attention_rel_pos: block_k={block_k} must cover whole grid rows (G={G})")
    return _k9(q, k, v, rel_h.float().contiguous(), rel_w.float().contiguous(), int(grid_side))


for _wrapper in (flash_windowed_fused, flash_attention_fused, flash_attention_rel_pos):
    _wrapper.launches = 0
    _wrapper.tc_launches = 0  # of those, the launches of csrc/attention_wgmma.cu
