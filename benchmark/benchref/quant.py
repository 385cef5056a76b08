"""The reference computed one precision below the configuration's: the
control that the comparison has to fail.

The configurations serve in bfloat16; the step below is 8-bit floating
point. Inside :func:`fp8`, every weight matrix and convolution kernel of the
given models is rounded to float8 e4m3 with one scale a tensor (its absolute
maximum onto 448), and so is the input of every linear, convolution,
transposed convolution and attention layer at each call; the arithmetic
stays float32, as an fp8 matmul accumulates in higher precision. On leaving,
the weights are restored.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point() or x.numel() == 0:
        return x
    scale = x.detach().abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _quantize_inputs(module, args, kwargs):
    return tuple(round_fp8(a) if isinstance(a, torch.Tensor) else a for a in args), kwargs


@contextlib.contextmanager
def fp8(*models: nn.Module):
    saved, hooks = [], []
    try:
        with torch.no_grad():
            for model in models:
                for m in model.modules():
                    if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.MultiheadAttention)):
                        hooks.append(m.register_forward_pre_hook(_quantize_inputs, with_kwargs=True))
                for p in model.parameters():
                    if p.ndim >= 2:
                        saved.append((p, p.detach().clone()))
                        p.copy_(round_fp8(p))
        yield
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for p, v in saved:
                p.copy_(v)
