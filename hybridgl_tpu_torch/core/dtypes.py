"""Storage dtype of attention score tensors (port of hybridgl_tpu/core/dtypes.py).

Matrix products always sum in f32; this module only decides the dtype in
which the score tensor is *stored* between the QK product and the PV product:

  * f32 activations (``compute_dtype="float32"``, the exact-parity config) ->
    f32 scores, plain softmax;
  * bf16 activations (the serving config) -> bf16 scores with the softmax
    denominator summed in f32;
  * ``HYBRIDGL_F32_SCORES=1`` forces f32 scores under bf16 activations (a
    debugging/accuracy knob).

The plain attention paths (the CLIP text encoder's causal attention; GEM's
trunk attention and self-self ensemble on the CPU, whose kernel keeps its
scores in f32 on the card) follow this policy cast for cast, so that under
bf16 the port rounds where the reference rounds.
"""

from __future__ import annotations

import torch

from ..utils.env import env_flag


def force_f32_scores() -> bool:
    return env_flag("HYBRIDGL_F32_SCORES", default=False)


def score_dtype(activation_dtype: torch.dtype) -> torch.dtype:
    if activation_dtype == torch.float32 or force_f32_scores():
        return torch.float32
    return activation_dtype


def softmax_scores(attn: torch.Tensor, axes=(-1,)) -> torch.Tensor:
    """Numerically stable softmax over ``axes`` (jointly) that tolerates bf16
    scores: max-shift and exp in the score dtype, the denominator summed in
    f32, the quotient cast back (all no-ops for f32 inputs)."""
    ax = tuple(axes)
    m = attn.amax(dim=ax, keepdim=True)
    e = torch.exp(attn - m)
    s = e.sum(dim=ax, keepdim=True, dtype=torch.float32)
    return (e.float() / s).to(attn.dtype)
