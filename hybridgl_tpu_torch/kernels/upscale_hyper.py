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
Either kernel runs the whole chain per tile of pixels on chip and writes the
interleaved f32 masks directly; only src goes in and the masks come out.
:func:`variant` says which a call takes: ``csrc/upscale_hyper_wgmma.cu`` on
the tensor cores for bf16 at SAM's widths (C = 256, c4 = 64, c8 = 32, m = 1
or 3, any g; the weights stay in shared memory as bf16, the chain stays in
registers, and what bounds it is the GELU's erf on the CUDA cores), and the
CUDA-core ``csrc/upscale_hyper.cu`` for f32 and every other width.

Dtype policy (the reference kernel's): operands in src's dtype, f32 sums,
LN in f32 computed directly, exact GELU, both GELU outputs rounded to the
dtype, hyper rows in the dtype. :func:`upscale_hyper` calls its operator,
``torch.ops.hybridgl.upscale_hyper_blocked`` (``_ops.py``, named after the TPU
kernel): on a CPU tensor it runs :func:`reference_upscale_hyper`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build, _ops

LN_EPS = 1e-6  # mask_decoder's LayerNorm2d
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
TC_WIDTHS = (256, 64, 32)  # C, c4, c8 the tensor-core kernel is built for
# its shared memory: w1, w2, two 64-pixel src stages, b1/ln_s/ln_b/b2
TC_SMEM = 2 * (256 * 256 + 64 * 128 + 2 * 64 * 256) + 4 * (3 * 64 + 32)


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


def variant(dtype, C: int, c4: int, c8: int, m: int) -> tuple[str, int]:
    """Which kernel a CUDA call takes and the shared memory it asks for:
    ("wgmma", bytes) or ("cuda-core", bytes). Mirrors the C dispatch
    (``hgl_upscale_hyper_tc_takes``, csrc/upscale_hyper_wgmma.cu)."""
    if dtype == torch.bfloat16 and (C, c4, c8) == TC_WIDTHS and m in (1, 3):
        return "wgmma", TC_SMEM
    tsize = 2 if dtype == torch.bfloat16 else 4
    smem = 4 * (max(16 * (C + 1), 64 * (4 * c8 + 1)) + 16 * (4 * c4 + 1) + 3 * c4 + c8 + m * c8)
    return "cuda-core", smem + tsize * (C * 4 * c4 + c4 * 4 * c8)  # csrc/upscale_hyper.cu Layout


def _launch(src, w1, b1, ln_s, ln_b, w2, b2, hyper):
    """The CUDA implementation of K4: check, launch, count."""
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
    kind, smem = variant(src.dtype, C, c4, c8, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"upscale_hyper: {smem} bytes of shared memory at C={C} c4={c4} c8={c8} in {src.dtype}")
    tc = kind == "wgmma"
    # the tensor-core kernel reads the weights and hyper rows in src's dtype (the decoder has
    # already rounded them to it); the CUDA-core kernel takes f32 and rounds per block
    wt = src.dtype if tc else torch.float32
    w1, w2, hyper = (t.to(wt).contiguous() for t in (w1, w2, hyper))
    b1, ln_s, ln_b, b2 = (t.float().contiguous() for t in (b1, ln_s, ln_b, b2))
    if tc and any(t.data_ptr() % 16 for t in (src, w1, w2, hyper)):
        raise ValueError("upscale_hyper: the tensor-core kernel copies 16 bytes at a time and needs 16-byte aligned tensors")
    out = torch.empty((B, m, 4 * g, 4 * g), dtype=torch.float32, device=src.device)
    sms = torch.cuda.get_device_properties(src.device).multi_processor_count
    # tensor cores: one persistent block an SM; CUDA cores: splits of a prompt's 16-pixel tiles
    nsplit = sms if tc else min(-(-R // 16), -(-2 * sms // B))
    lib = _build.library()
    code = lib.hgl_upscale_hyper(
        src.data_ptr(), w1.data_ptr(), b1.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), hyper.data_ptr(), out.data_ptr(), B, R, g, C, c4, c8, m, nsplit,
        int(src.dtype == torch.bfloat16), int(tc), _build.stream_handle(src.device),
    )
    _build.check(code, "upscale_hyper")
    upscale_hyper.launches += 1
    upscale_hyper.tc_launches += int(tc)
    return out


def _fake(src, w1, b1, ln_s, ln_b, w2, b2, hyper):
    g = math.isqrt(src.shape[1])
    return src.new_empty((src.shape[0], hyper.shape[1], 4 * g, 4 * g), dtype=torch.float32)


_k4 = _ops.define(
    "upscale_hyper_blocked(Tensor src, Tensor w1, Tensor b1, Tensor ln_s, Tensor ln_b, Tensor w2, Tensor b2, "
    "Tensor hyper) -> Tensor", reference_upscale_hyper, _launch, _fake)


def upscale_hyper(src, w1, b1, ln_s, ln_b, w2, b2, hyper):
    """K4: src [B, g*g, C], w1 [C, 4*c4] (columns (i, j, c4)), b1/ln_s/ln_b
    [c4], w2 [c4, 4*c8] (columns (e, f, c8)), b2 [c8], hyper [B, m, c8]
    -> masks [B, m, 4g, 4g] f32 (``torch.ops.hybridgl.upscale_hyper_blocked``)."""
    return _k4(src, w1, b1, ln_s, ln_b, w2, b2, hyper)


upscale_hyper.launches = 0
upscale_hyper.tc_launches = 0  # of those, the launches of csrc/upscale_hyper_wgmma.cu
