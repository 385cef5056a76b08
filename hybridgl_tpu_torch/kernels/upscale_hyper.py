"""The SAM mask decoder's upscale + hypernetwork tail (K4).

:func:`upscale_hyper` replaces the Pallas kernel ``upscale_hyper_blocked``
(``hybridgl_tpu/kernels/upscale_hyper.py:153``) together with its
``interleave_blocked_masks``. The tail (reference mask_decoder.py:53-59,
136-144) is

    x = gelu(LN2d(deconv1(src)))     2x2 stride 2: C -> c4, eps 1e-6
    x = gelu(deconv2(x))             2x2 stride 2: c4 -> c8
    masks[m] = hyper[m] . x          per-token channel contraction

Both deconvs have kernel == stride == 2, so each is a per-pixel matmul onto
a 2x2 sub-grid: pixel (h, w) of the g x g grid, first sub-pixel (i, j),
second (e, f) lands at row 4h+2i+e, column 4w+2j+f of the [4g, 4g] mask.
The kernel (``csrc/upscale_hyper.cu``) runs the whole chain per tile of
pixels in shared memory and writes the interleaved f32 masks directly; only
src goes in and the masks come out.

Dtype policy (the reference kernel's): operands in src's dtype, f32 sums,
LN in f32 computed directly, exact GELU, both GELU outputs rounded to the
dtype, hyper rows in the dtype. On a CPU tensor :func:`upscale_hyper` runs
:func:`reference_upscale_hyper`; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

LN_EPS = 1e-6  # mask_decoder's LayerNorm2d
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90


def interleave(y, g: int):
    """[B, m, g*g, (i, j, e, f)] -> [B, m, 4g, 4g] with rows (h, i, e) and
    columns (w, j, f), the deconvs' pixel order."""
    B, m = y.shape[:2]
    y8 = y.reshape(B, m, g, g, 2, 2, 2, 2)  # b m h w i j e f
    return y8.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(B, m, 4 * g, 4 * g)


def reference_upscale_hyper(src, w1, b1, ln_s, ln_b, w2, b2, hyper):
    """Plain PyTorch version of K4 -> masks [B, m, 4g, 4g] f32."""
    B, R, _ = src.shape
    g = math.isqrt(R)
    c4, c8 = w1.shape[1] // 4, w2.shape[1] // 4
    dt = src.dtype
    d = torch.matmul(src.float(), w1.to(dt).float()).reshape(B, R, 4, c4) + b1.float()
    mu = d.mean(-1, keepdim=True)
    var = (d - mu).square().mean(-1, keepdim=True)
    z1 = (d - mu) * torch.rsqrt(var + LN_EPS) * ln_s.float() + ln_b.float()
    h1 = F.gelu(z1).to(dt)
    z2 = torch.matmul(h1.float(), w2.to(dt).float()).reshape(B, R, 16, c8) + b2.float()
    h2 = F.gelu(z2).to(dt)
    y = torch.einsum("brqc,bmc->bmrq", h2.float(), hyper.to(dt).float())
    return interleave(y, g)


def upscale_hyper(src, w1, b1, ln_s, ln_b, w2, b2, hyper):
    """K4: src [B, g*g, C], w1 [C, 4*c4] (columns (i, j, c4)), b1/ln_s/ln_b
    [c4], w2 [c4, 4*c8] (columns (e, f, c8)), b2 [c8], hyper [B, m, c8]
    -> masks [B, m, 4g, 4g] f32."""
    if src.device.type == "cpu":
        return reference_upscale_hyper(src, w1, b1, ln_s, ln_b, w2, b2, hyper)
    if src.device.type != "cuda":
        raise RuntimeError(f"upscale_hyper: unsupported device {src.device}")
    if src.ndim != 3 or src.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"upscale_hyper: src must be [B, g*g, C] bf16 or f32, got {tuple(src.shape)} {src.dtype}")
    if not src.is_contiguous():
        raise ValueError("upscale_hyper: inputs must be contiguous")
    B, R, C = src.shape
    g = math.isqrt(R)
    c4, c8, m = w1.shape[-1] // 4, w2.shape[-1] // 4, hyper.shape[1]
    shapes = {"w1": (w1, (C, 4 * c4)), "b1": (b1, (c4,)), "ln_s": (ln_s, (c4,)), "ln_b": (ln_b, (c4,)),
              "w2": (w2, (c4, 4 * c8)), "b2": (b2, (c8,)), "hyper": (hyper, (B, m, c8))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"upscale_hyper: {name} must be {list(shape)}, got {tuple(t.shape)}")
        if t.device != src.device:
            raise ValueError("upscale_hyper: tensors on different devices")
    if g * g != R:
        raise ValueError(f"upscale_hyper: unsupported shape g*g={R} C={C} c4={c4} c8={c8} m={m}")
    tsize = src.element_size()
    smem = 4 * (max(16 * (C + 1), 64 * (4 * c8 + 1)) + 16 * (4 * c4 + 1) + 3 * c4 + c8 + m * c8)
    smem += tsize * (C * 4 * c4 + c4 * 4 * c8)  # csrc/upscale_hyper.cu Layout
    if smem > SMEM_LIMIT:
        raise ValueError(f"upscale_hyper: {smem} bytes of shared memory at C={C} c4={c4} c8={c8} in {src.dtype}")
    w1, b1, ln_s, ln_b, w2, b2, hyper = (t.float().contiguous() for t in (w1, b1, ln_s, ln_b, w2, b2, hyper))
    out = torch.empty((B, m, 4 * g, 4 * g), dtype=torch.float32, device=src.device)
    ntiles = -(-R // 16)
    sms = torch.cuda.get_device_properties(src.device).multi_processor_count
    nsplit = min(ntiles, -(-2 * sms // B))
    lib = _build.library()
    code = lib.hgl_upscale_hyper(
        src.data_ptr(), w1.data_ptr(), b1.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), hyper.data_ptr(), out.data_ptr(), B, R, g, C, c4, c8, m, nsplit,
        int(src.dtype == torch.bfloat16), _build.stream_handle(src.device),
    )
    _build.check(code, "upscale_hyper")
    upscale_hyper.launches += 1
    return out


upscale_hyper.launches = 0
