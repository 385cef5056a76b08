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

On a CPU tensor the wrapper runs :func:`reference_i2t_ln_then_t2i`; on a
CUDA tensor it launches ``csrc/decoder_attn.cu`` in PASS mode or raises.
"""

from __future__ import annotations

from .decoder_attn import PASS, _f32, _launch, reference_i2t_ln_update
from .decoder_attn_t2i import reference_t2i_ctx


def reference_i2t_ln_then_t2i(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, heads: int, tp: int,
                              shared_qside: bool):
    """Plain PyTorch version of K3: (keys' [B, S, C], ctx [B, GT2, C] f32)."""
    if shared_qside:
        keys = reference_i2t_ln_update(qside, base, w, off, vo, const, ln_scale, ln_bias, heads, tp)
    else:
        keys = reference_i2t_ln_update(qside, qside, w, off, vo, const, ln_scale, ln_bias, heads, tp, pe=pe)
    return keys, reference_t2i_ctx(keys, pe, qw_next)


def i2t_ln_then_t2i(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, heads: int, tp: int,
                    shared_qside: bool):
    """K3: qside [1 or B, S, Cq], base [1 or B, S, C] (used when shared),
    pe [1 or B, S, C], w [B, Cq, GT] f32, off [B, GT] f32, vo [B, GT, C],
    const/ln [C] f32, qw_next [B, C, GT2] f32 -> (keys' [B, S, C], ctx
    [B, GT2, C] f32)."""
    if qside.device.type == "cpu":
        return reference_i2t_ln_then_t2i(qside, base, pe, w, off, vo, const, ln_scale, ln_bias, qw_next, heads, tp,
                                         shared_qside)
    if qside.device.type != "cuda":
        raise RuntimeError(f"i2t_ln_then_t2i: unsupported device {qside.device}")
    dt = base.dtype if shared_qside else qside.dtype
    B, S, C = w.shape[0], qside.shape[1], (base.shape[-1] if shared_qside else qside.shape[-1])
    keys, ctx = _launch(
        "i2t_ln_then_t2i", PASS, B, S, C, qside=qside.to(dt), base=base if shared_qside else qside,
        pe=pe.to(dt), w=_f32(w), off=_f32(off), vo=vo.to(dt).contiguous(), const=_f32(const),
        ln_scale=_f32(ln_scale), ln_bias=_f32(ln_bias), qw=_f32(qw_next), heads=heads, tp=tp,
        add_pe=not shared_qside,
    )
    i2t_ln_then_t2i.launches += 1
    return keys, ctx


i2t_ln_then_t2i.launches = 0
