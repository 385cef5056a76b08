"""The fused decoder layer pass (K3): image->token update + the next
token->image accumulation in one sweep over the image rows.

:func:`i2t_ln_then_t2i` replaces the Pallas kernel of the same name
(``hybridgl_tpu/kernels/decoder_pass.py:209``). The next t2i's score weights
depend only on token state that is complete before layer i's i2t runs, so
each tile of keys' = LN(base + i2t(qside)) (K7's math) feeds the next t2i's
online column softmax (K8's math) straight from shared memory: keys' is
written once and never read back by this pass. Two modes:

  * ``shared_qside=True`` (pass A, decoder layer 0): qside is the once-
    projected image queries [1, S, Cq] and base the raw image [1, S, C],
    both broadcast over the prompts;
  * ``shared_qside=False`` (pass B): qside == base == the per-prompt keys,
    with pe added on the score side.

The wrapper calls its operator, ``torch.ops.hybridgl.i2t_ln_then_t2i``
(``_ops.py``): on a CPU tensor it runs :func:`reference_i2t_ln_then_t2i`; on a
CUDA tensor it launches the PASS mode of one of two kernels or raises
(``decoder_attn.variant`` says which): bf16 at SAM's widths (C = 256, 8
heads x tp 8, GT2 = 64, S a multiple of 64) runs
``csrc/decoder_attn_wgmma.cu``, whose four products are ``wgmma`` with the
token-side operands resident in shared memory, both softmaxes and the LN
on the accumulator fragments, and keys' / kpe written over the stage they
were computed from; what bounds it is that element-wise work, which its
two warpgroups do in lockstep (``PERF.md``). f32 and every other shape run
the CUDA-core ``csrc/decoder_attn.cu``. One block of that kernel keeps the
token-side operands in shared memory and the context sums in registers, which
at SAM's width holds 8 token lanes a head; a prompt of more than 8 tokens (a
box with two or more points: 16 lanes a head) runs the pass as its two halves
in the same kernels, the I2T mode and then the T2I mode over groups of 64
context columns, which are independent of one another (:func:`pass_route`).
"""

from __future__ import annotations

import torch

from . import _ops
from .decoder_attn import I2T, MAX_CTX, PASS, SMEM_LIMIT, T2I, _f32, _launch, reference_i2t_ln_update, variant
from .decoder_attn_t2i import reference_t2i_ctx


def reference_i2t_ln_then_t2i(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, heads: int, tp: int,
                              shared_qside: bool):
    """Plain PyTorch version of K3: (keys' [B, S, C], ctx [B, GT2, C] f32)."""
    if shared_qside:
        keys = reference_i2t_ln_update(qside, base, w, off, vo, const, ln_scale, ln_bias, heads, tp)
    else:
        keys = reference_i2t_ln_update(qside, qside, w, off, vo, const, ln_scale, ln_bias, heads, tp, pe=pe)
    return keys, reference_t2i_ctx(keys, pe, qw_next)


def pass_route(dtype, S: int, Cq: int, C: int, heads: int, tp: int, GT2: int, shared_qside: bool) -> str:
    """How a CUDA call of K3 runs, by dtype and shape alone: "wgmma" or
    "cuda-core" (one launch in PASS mode), or "split" where the CUDA-core
    kernel cannot hold the pass in one block (GT2 * C context sums in
    registers, the operands in shared memory): the I2T mode, then the T2I
    mode per group of :func:`split_columns` context columns."""
    kind, smem = variant(PASS, dtype, S, Cq, C, heads, tp, GT2, not shared_qside, not shared_qside)
    if kind == "cuda-core" and (GT2 * C > MAX_CTX or smem > SMEM_LIMIT):
        return "split"
    return kind


def split_columns(C: int, GT2: int) -> int:
    """Context columns per T2I launch of the split route."""
    return max(4, min(GT2, MAX_CTX // C // 4 * 4))


def _launch_pass(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, heads: int, tp: int,
                 shared_qside: bool):
    """The CUDA implementation of K3: check, launch (once, or on the split
    route once for the I2T half and once a column group), count."""
    dt = base.dtype if shared_qside else qside.dtype
    B, S, C = w.shape[0], qside.shape[1], (base.shape[-1] if shared_qside else qside.shape[-1])
    i2t = dict(qside=qside.to(dt), base=base if shared_qside else qside, pe=pe.to(dt), w=_f32(w), off=_f32(off),
               vo=vo.to(dt).contiguous(), const=_f32(const), ln_scale=_f32(ln_scale), ln_bias=_f32(ln_bias),
               heads=heads, tp=tp, add_pe=not shared_qside)
    GT2 = qw_next.shape[-1]
    if pass_route(dt, S, qside.shape[-1], C, heads, tp, GT2, shared_qside) == "split":
        if shared_qside:
            i2t["pe"] = None  # the shared score side carries no pe; the T2I half adds it to keys'
        keys, _, tc = _launch("i2t_ln_then_t2i", I2T, B, S, C, **i2t)
        on_tc, step, parts = [tc], split_columns(C, GT2), []
        for at in range(0, GT2, step):
            _, part, tc = _launch("i2t_ln_then_t2i", T2I, B, S, C, qside=keys, pe=pe.to(dt),
                                  qw=_f32(qw_next[:, :, at : at + step]))
            parts.append(part)
            on_tc.append(tc)
        ctx = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    else:
        keys, ctx, tc = _launch("i2t_ln_then_t2i", PASS, B, S, C, qw=_f32(qw_next), **i2t)
        on_tc = [tc]
    i2t_ln_then_t2i.launches += len(on_tc)  # one a kernel launch: the split route makes 1 + GT2 / step
    i2t_ln_then_t2i.tc_launches += sum(on_tc)
    return keys, ctx


def _fake_pass(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, heads, tp, shared_qside):
    dt, C = (base.dtype, base.shape[-1]) if shared_qside else (qside.dtype, qside.shape[-1])
    B, S, GT2 = w.shape[0], qside.shape[1], qw_next.shape[-1]
    return qside.new_empty((B, S, C), dtype=dt), qside.new_empty((B, GT2, C), dtype=torch.float32)


_k3 = _ops.define(
    "i2t_ln_then_t2i(Tensor qside, Tensor base, Tensor pe, Tensor w, Tensor off, Tensor vo, Tensor const, "
    "Tensor ln_scale, Tensor ln_bias, Tensor qw_next, int heads, int tp, bool shared_qside) -> (Tensor, Tensor)",
    reference_i2t_ln_then_t2i, _launch_pass, _fake_pass)


def i2t_ln_then_t2i(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, heads: int, tp: int,
                    shared_qside: bool):
    """K3: qside [1 or B, S, Cq], base [1 or B, S, C] (used when shared),
    pe [1 or B, S, C], w [B, Cq, GT] f32, off [B, GT] f32, vo [B, GT, C],
    const/ln [C] f32, qw_next [B, C, GT2] f32 -> (keys' [B, S, C], ctx
    [B, GT2, C] f32) (``torch.ops.hybridgl.i2t_ln_then_t2i``)."""
    return _k3(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, int(heads), int(tp),
               bool(shared_qside))


i2t_ln_then_t2i.launches = 0
i2t_ln_then_t2i.tc_launches = 0  # of those, the launches of csrc/decoder_attn_wgmma.cu
