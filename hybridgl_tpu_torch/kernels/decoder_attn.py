"""Image->token cross-attention + LayerNorm for the SAM decoder (K7).

:func:`i2t_ln_update` replaces the Pallas kernel of the same name
(``hybridgl_tpu/kernels/decoder_attn.py:95``). With the projections
side-switched onto the ~7 prompt tokens (``models/sam/decoder.py``), what is
left per prompt b over the S = g*g image tokens is

    scores[q, (h,t)] = qside[b?, q, :] . w_b[:, (h,t)] + off_b[(h,t)]
    attn             = softmax over t within each head's tp lanes
    keys'[q, :]      = LN(base[b?, q, :] + attn[q, :] @ vo_b + const)

qside, base (and pe, added to qside when given) may be [1, S, .] and then
broadcast over the prompts without being materialised. Padding lanes
(t >= T) carry off = -1e30, so their exp is exactly 0.

One C entry point serves K7, K8 (``decoder_attn_t2i.t2i_ctx``) and K3
(``decoder_pass.i2t_ln_then_t2i``); :func:`_launch` is their common wrapper.
Two kernels stand behind it (:func:`variant` says which a call takes):
``csrc/decoder_attn_wgmma.cu`` on the tensor cores for bf16 at SAM's widths
(C = 256, 8 heads x tp 8, GT2 = 64, S a multiple of 64; what bounds it is
the element-wise work between its four products, not the products or the
0.5 GB of image stream), and the CUDA-core ``csrc/decoder_attn.cu`` for f32
and every other shape (ragged S included). Each wrapper calls its operator,
``torch.ops.hybridgl.<name>`` (``_ops.py``): on a CPU tensor it runs its plain
PyTorch version; on a CUDA tensor it launches a kernel or raises.
The plain versions round to the stream dtype where the kernels do: w before
the score product, attn before the vo product, keys' before the next t2i,
kpe = keys + pe, qw, and p before p^T keys.
"""

from __future__ import annotations

import torch

from . import _build, _ops

LN_EPS = 1e-5  # decoder norms are default torch LayerNorm
TILE_ROWS = 32  # image rows per tile of the CUDA-core kernel (csrc/decoder_attn.cu TR)
TC_TILE_ROWS = 64  # and of the tensor-core kernel (csrc/decoder_attn_wgmma.cu ROWS)
TC_WIDTH, TC_LANES = 256, 64  # the channels and token lanes the tensor-core kernel is built for
# its shared memory: w/vo/qw^T tiles, two stages of two 64 x 256 tiles, off, the LN exchange
TC_SMEM = 3 * 32768 + 2 * 65536 + 4 * TC_LANES + 4 * 2 * TC_TILE_ROWS * 2
MAX_CTX = 256 * 4 * 16  # GT2 * C the kernel keeps in registers per block
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
I2T, T2I, PASS = 0, 1, 2  # kernel modes


def _grouped_softmax(s, heads: int, tp: int):
    """Softmax over each head's tp lanes of s [..., heads * tp] (f32)."""
    sh = s.reshape(s.shape[:-1] + (heads, tp))
    e = torch.exp(sh - sh.amax(-1, keepdim=True))
    r = 1.0 / e.sum(-1, keepdim=True).clamp(min=1e-30)
    return (e * r).reshape(s.shape)


def _ln_rows(x, scale, bias):
    """Row LayerNorm of f32 x in the reference's sufficient-statistics form."""
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


def reference_i2t_ln_update(qside, base, w, off, vo, const, ln_scale, ln_bias, heads: int, tp: int, pe=None):
    """Plain PyTorch version of K7: LN(base + i2t(qside [+ pe])) as [B, S, Co]."""
    dt = base.dtype
    q = qside.to(dt)
    if pe is not None:
        q = (q.float() + pe.to(dt).float()).to(dt)
    s = torch.matmul(q.float(), w.to(dt).float()) + off.float()[:, None, :]
    attn = _grouped_softmax(s, heads, tp).to(dt)
    x = base.float() + torch.matmul(attn.float(), vo.to(dt).float()) + const.float()
    return _ln_rows(x, ln_scale, ln_bias).to(dt)


def _f32(t):
    return t.float().contiguous()


def variant(mode: int, dtype, S: int, Cq: int, C: int, heads: int, tp: int, GT2: int, add_pe: bool,
            same_base: bool) -> tuple[str, int]:
    """Which kernel a CUDA call takes and the shared memory it asks for:
    ("wgmma", bytes) or ("cuda-core", bytes). Mirrors the C dispatch
    (``hgl_decoder_attn_tc_takes``, csrc/decoder_attn_wgmma.cu): bf16, C = 256,
    S a multiple of 64, and for K3/K7 8 heads x tp 8 in one of two operand
    forms: qside and base one tensor scored with pe (``same_base`` and
    ``add_pe``, Cq = 256), or a 128-wide score side without pe; K3/K8 need
    GT2 = 64."""
    GT = heads * tp
    tc = dtype == torch.bfloat16 and C == TC_WIDTH and S >= TC_TILE_ROWS and S % TC_TILE_ROWS == 0
    if mode == T2I:
        tc = tc and GT2 == TC_LANES and Cq == C
    else:
        tc = tc and heads == 8 and tp == 8 and (mode == I2T or GT2 == TC_LANES)
        tc = tc and ((same_base and Cq == C) if add_pe else (not same_base and Cq == 128))
    if tc:
        return "wgmma", TC_SMEM
    LQ, LX, LS = max(Cq, C) + 1, C + 1, max(GT, GT2) + 1  # csrc/decoder_attn.cu Layout
    smem = 4 * (TILE_ROWS * (LQ + LX + LS) + GT + 3 * C + 3 * GT2)
    tsize = 2 if dtype == torch.bfloat16 else 4
    smem += tsize * ((Cq * GT + GT * C if mode != T2I else 0) + (C * GT2 if mode != I2T else 0))
    return "cuda-core", smem


def _num_splits(B: int, S: int, device, tc: bool) -> int:
    """Row splits per prompt, no split left empty: one wave of one block an
    SM for the tensor-core kernel (its shared memory allows no second),
    about two blocks an SM for the CUDA-core kernel."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ntiles, want = (S // TC_TILE_ROWS, sms // B) if tc else (-(-S // TILE_ROWS), -(-2 * sms // B))
    per = -(-ntiles // max(1, min(ntiles, want)))
    return -(-ntiles // per)


def _launch(name, mode, B, S, C, *, qside, base=None, pe=None, w=None, off=None, vo=None, const=None,
            ln_scale=None, ln_bias=None, qw=None, heads=1, tp=8, add_pe=False):
    """Check the operands and launch csrc/decoder_attn.cu in ``mode``.
    Returns (keys' [B, S, C] or None, ctx [B, GT2, C] f32 or None, whether
    the call took the tensor-core kernel)."""
    dev, dt = qside.device, qside.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: image streams must be bf16 or f32, got {dt}")
    Cq = qside.shape[-1]
    streams = [("qside", qside, Cq)] + [(n, t, C) for n, t in (("base", base), ("pe", pe)) if t is not None]
    for n, t, width in streams:
        if t.ndim != 3 or t.shape[0] not in (1, B) or tuple(t.shape[1:]) != (S, width):
            raise ValueError(f"{name}: {n} must be [1 or {B}, {S}, {width}], got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {n} dtype {t.dtype} differs from qside's {dt}")
    if add_pe and Cq != C:
        raise ValueError(f"{name}: pe on the score side needs Cq == C, got {Cq} and {C}")
    GT = heads * tp
    GT2 = qw.shape[-1] if qw is not None else 4
    f32 = {"w": (w, (B, Cq, GT)), "off": (off, (B, GT)), "const": (const, (C,)), "ln_scale": (ln_scale, (C,)),
           "ln_bias": (ln_bias, (C,)), "qw": (qw, (B, C, GT2))}
    for n, (t, shape) in f32.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {n} must be {list(shape)}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {n} must be f32")
    if vo is not None:
        if tuple(vo.shape) != (B, GT, C) or vo.dtype != dt:
            raise ValueError(f"{name}: vo must be [{B}, {GT}, {C}] in {dt}, got {tuple(vo.shape)} {vo.dtype}")
    if not (1 <= tp <= 32) or GT % 4 or C % 4 or GT2 % 4 or C > 256 or Cq > 256 or GT2 * C > MAX_CTX:
        raise ValueError(f"{name}: unsupported widths tp={tp} GT={GT} GT2={GT2} Cq={Cq} C={C}")
    same_base = base is not None and base.data_ptr() == qside.data_ptr() and base.shape == qside.shape
    kind, smem = variant(mode, dt, S, Cq, C, heads, tp, GT2, add_pe, same_base)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {smem} bytes of shared memory at Cq={Cq} C={C} GT={GT} GT2={GT2} in {dt}")
    tensors = [t for _, t, _ in streams] + [t for t, _ in f32.values() if t is not None] + ([vo] if vo is not None else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")

    tc = kind == "wgmma"
    if tc and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the tensor-core kernel copies 16 bytes at a time and needs 16-byte aligned tensors")
    if tc:  # rounded (and qw transposed) once here, not once a block
        w = None if w is None else w.to(dt)
        qw = None if qw is None else qw.transpose(1, 2).to(dt).contiguous()
    keys = torch.empty((B, S, C), dtype=dt, device=dev) if mode != T2I else None
    ctx = part = None
    nsplit = _num_splits(B, S, dev, tc)
    if mode != I2T:
        ctx = torch.empty((B, GT2, C), dtype=torch.float32, device=dev)
        part = torch.empty((B * nsplit * GT2 * (2 + C),), dtype=torch.float32, device=dev)
    n = B * nsplit * GT2

    def ptr(t, offset=0):
        return 0 if t is None else t.data_ptr() + 4 * offset

    lib = _build.library()
    code = lib.hgl_decoder_attn(
        mode, ptr(qside), ptr(base), ptr(pe), ptr(w), ptr(off), ptr(vo), ptr(const), ptr(ln_scale), ptr(ln_bias),
        ptr(qw), ptr(keys), ptr(part), ptr(part, n), ptr(part, 2 * n), ptr(ctx),
        B, S, Cq, C, heads, tp, GT2, nsplit,
        int(qside.shape[0] == 1), int(base is not None and base.shape[0] == 1),
        int(pe is not None and pe.shape[0] == 1), int(add_pe), int(dt == torch.bfloat16), int(tc),
        _build.stream_handle(dev),
    )
    _build.check(code, name)
    return keys, ctx, tc


def _launch_i2t(qside, base, w, off, vo, const, ln_scale, ln_bias, heads: int, tp: int, pe=None):
    """The CUDA implementation of K7: check, launch, count."""
    dt = base.dtype
    B, S, Co = w.shape[0], qside.shape[1], base.shape[-1]
    keys, _, tc = _launch(
        "i2t_ln_update", I2T, B, S, Co, qside=qside.to(dt), base=base,
        pe=None if pe is None else pe.to(dt), w=_f32(w), off=_f32(off), vo=vo.to(dt).contiguous(), const=_f32(const),
        ln_scale=_f32(ln_scale), ln_bias=_f32(ln_bias), heads=heads, tp=tp, add_pe=pe is not None,
    )
    i2t_ln_update.launches += 1
    i2t_ln_update.tc_launches += int(tc)
    return keys


_k7 = _ops.define(
    "i2t_ln_update(Tensor qside, Tensor base, Tensor w, Tensor off, Tensor vo, Tensor const, Tensor ln_scale, "
    "Tensor ln_bias, int heads, int tp, Tensor? pe) -> Tensor",
    reference_i2t_ln_update, _launch_i2t,
    lambda qside, base, w, *_: base.new_empty((w.shape[0], qside.shape[1], base.shape[-1])))


def i2t_ln_update(qside, base, w, off, vo, const, ln_scale, ln_bias, heads: int, tp: int, pe=None):
    """K7: qside [1 or B, S, Cq], base [1 or B, S, Co], w [B, Cq, GT] f32,
    off [B, GT] f32, vo [B, GT, Co], const/ln_scale/ln_bias [Co] f32, pe
    [1 or B, S, Cq] or None -> keys' [B, S, Co] in base's dtype
    (``torch.ops.hybridgl.i2t_ln_update``)."""
    return _k7(qside, base, w, off, vo, const, ln_scale, ln_bias, int(heads), int(tp), pe)


i2t_ln_update.launches = 0
i2t_ln_update.tc_launches = 0  # of those, the launches of csrc/decoder_attn_wgmma.cu
