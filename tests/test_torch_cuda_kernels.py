"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (partial tiles, every supported head dim, K9's
TPU tiles, K10's ragged n, n2 and C; for the
decoder kernels S = 300, tp in {8, 16}, heads in {2, 8}, Cq != C, B = 3), in
f32 and bf16. Marked ``cuda``; each test skips where no CUDA card is present.
Run on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerances: f32 max|d| <= 1e-4 (f32 math on both sides, summed in another
order); bf16 outputs cos >= 0.999 (one bf16 rounding of the output).

The decoder kernels' tensor-core variants (bf16 at SAM's widths: C = 256, 8
heads x tp 8, c4 = 64, c8 = 32) are held to the kernel check's bars at S =
64, 4096 and a ragged S, with a B that leaves the last row split short,
scores x40, broadcast and per-prompt pe, and bit-equality of two runs; the
Python ``variant`` functions are held to the C dispatch they mirror.

K1 and K2 are also held at the head counts a rank of the tensor-parallel
encoder gives them (8 and 4 heads at head dim 80, short and ragged S), and K3
and K4 fed from the prepared decoder operands against the raw ones.

The ten registered operators (``torch.ops.hybridgl.*``): each on CUDA tensors
equal bit for bit to the ctypes launch it dispatches to, at production shapes;
``opcheck`` on the card for K1, K2 and K6; an encoder exported on the card
equal to the eager port there, every launch of its run on the tensor cores.
"""

import pytest
import torch

from hybridgl_tpu_torch.kernels import _build, decoder_attn, upscale_hyper as upscale_mod
from hybridgl_tpu_torch.kernels.clip_attention import clip_attention, reference_clip_attention
from hybridgl_tpu_torch.kernels.decoder_attn import i2t_ln_update, reference_i2t_ln_update
from hybridgl_tpu_torch.kernels.decoder_attn_t2i import reference_t2i_ctx, t2i_ctx
from hybridgl_tpu_torch.kernels.decoder_pass import i2t_ln_then_t2i, reference_i2t_ln_then_t2i
from hybridgl_tpu_torch.kernels.flash_attention import (
    flash_attention_fused,
    flash_attention_rel_pos,
    flash_windowed_fused,
    reference_attention_rel_pos,
)
from hybridgl_tpu_torch.kernels.pass1_stats import (
    half_transform,
    pass1_stats,
    pass1_stats_half,
    reference_pass1_stats_half,
)
from hybridgl_tpu_torch.kernels.resize import _composed_axis_weights
from hybridgl_tpu_torch.kernels.upscale_hyper import reference_upscale_hyper, upscale_hyper

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def close(got, want, dtype):
    g, w = got.float().flatten(), want.float().flatten()
    assert torch.isfinite(g).all()
    if dtype == torch.float32:
        assert float((g - w).abs().max()) <= 1e-4
    else:
        assert float(g @ w / (g.norm() * w.norm())) >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn", [flash_windowed_fused, flash_attention_fused])
@pytest.mark.parametrize("G,hd", [(3, 16), (8, 32), (9, 64), (14, 80)])
def test_rel_pos_attention(dev, dtype, fn, G, hd):
    g = torch.Generator(device=dev).manual_seed(G * hd)
    BH, S = 5, G * G
    q, k, v = (torch.randn((BH, S, hd), generator=g, device=dev).to(dtype) for _ in range(3))
    rh, rw = (torch.randn((BH, S, G), generator=g, device=dev) * 0.5 for _ in range(2))
    before = fn.launches
    got = fn(q, k, v, rh, rw, G, hd**-0.5)
    assert fn.launches == before + 1
    close(got, reference_attention_rel_pos(q, k, v, rh, rw, G, hd**-0.5), dtype)


@pytest.mark.parametrize("fn,BH,G,hd", [
    (flash_windowed_fused, 400, 14, 80),  # K1 at ViT-H: 25 windows x 16 heads, the resident kernel
    (flash_attention_fused, 16, 64, 80),  # K2 at ViT-H: the stream kernel
    (flash_windowed_fused, 7, 14, 64),    # ragged S = 196 at the other tensor-core head dim
    (flash_attention_fused, 3, 64, 64),
    (flash_windowed_fused, 5, 8, 80),     # S = 64: one query tile, one key tile
    (flash_windowed_fused, 5, 16, 64),    # S = 256: the largest resident S, four full key tiles
    (flash_windowed_fused, 5, 5, 80),     # S = 25: keys padded to 32
    (flash_attention_fused, 4, 32, 80),   # G = 32, S = 1024: bf16 outside the tensor-core kernels' geometry
])
def test_rel_pos_attention_bf16_tensor_core(dev, fn, BH, G, hd):
    """The bf16 geometries of the tensor-core kernels (and one beside them)
    against the f32 plain version, at the kernel check's attention bar."""
    g = torch.Generator(device=dev).manual_seed(BH + G + hd)
    S = G * G
    q, k, v = (torch.randn((BH, S, hd), generator=g, device=dev).bfloat16() for _ in range(3))
    rh, rw = (torch.randn((BH, S, G), generator=g, device=dev) * 0.5 for _ in range(2))
    got = fn(q, k, v, rh, rw, G, hd**-0.5).float().flatten()
    torch.cuda.synchronize()
    want = reference_attention_rel_pos(q.float(), k.float(), v.float(), rh, rw, G, hd**-0.5).flatten()
    assert torch.isfinite(got).all()
    assert float(got @ want / (got.norm() * want.norm())) >= 0.999
    assert float((got - want).abs().mean() / want.abs().mean()) < 0.02


@pytest.mark.parametrize("G,hd", [(5, 80), (8, 80), (8, 64), (12, 80), (12, 64), (13, 80)])
def test_rel_pos_resident_short_sequences_under_load(dev, G, hd):
    """One to three key tiles (S = 25, 64, 144, 169) with thousands of
    window-heads in flight, so that the K/V copies really lag the first
    product: every output element is held to the plain version, not only
    the mean, since a tile read before it landed spoils single rows."""
    BH, S = 2400, G * G
    g = torch.Generator(device=dev).manual_seed(G * hd)
    q, k, v = (torch.randn((BH, S, hd), generator=g, device=dev).bfloat16() for _ in range(3))
    rh, rw = (torch.randn((BH, S, G), generator=g, device=dev) * 0.5 for _ in range(2))
    want = reference_attention_rel_pos(q.float(), k.float(), v.float(), rh, rw, G, hd**-0.5)
    for _ in range(3):
        got = flash_windowed_fused(q, k, v, rh, rw, G, hd**-0.5).float()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_pos_entries_count_one_launch_each(dev, dtype):
    """The bf16 (tensor-core) and f32 (CUDA-core) entries each count one
    launch per call, on the wrapper that was called and on no other."""
    g = torch.Generator(device=dev).manual_seed(0)
    G, hd, BH = 14, 80, 3
    q, k, v = (torch.randn((BH, G * G, hd), generator=g, device=dev).to(dtype) for _ in range(3))
    rh, rw = (torch.randn((BH, G * G, G), generator=g, device=dev) * 0.5 for _ in range(2))
    wrappers = (flash_windowed_fused, flash_attention_fused, flash_attention_rel_pos)
    for fn in wrappers:
        before = [w.launches for w in wrappers]
        if fn is flash_attention_rel_pos:
            fn(q, k, v, rh, rw, G, block_q=196, block_k=196)
        else:
            fn(q, k, v, rh, rw, G, hd**-0.5)
        assert [w.launches - b for w, b in zip(wrappers, before)] == [int(w is fn) for w in wrappers]


def test_rel_pos_attention_rejects_misaligned(dev):
    G, hd = 8, 64
    buf = torch.zeros(3 * G * G * hd + 1, device=dev, dtype=torch.bfloat16)
    q = buf[1:].view(3, G * G, hd)  # contiguous, 2 bytes off a 16-byte boundary
    k = v = torch.zeros((3, G * G, hd), device=dev, dtype=torch.bfloat16)
    rh = rw = torch.zeros((3, G * G, G), device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_windowed_fused(q, k, v, rh, rw, G, hd**-0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,hd,with_bias", [(17, 16, True), (65, 64, True), (197, 64, False)])
def test_clip_attention(dev, dtype, L, hd, with_bias):
    g = torch.Generator(device=dev).manual_seed(L)
    N, H = 3, 2
    q, k, v = (torch.randn((N * H, L, hd), generator=g, device=dev).to(dtype) for _ in range(3))
    bias = None
    if with_bias:
        allowed = torch.rand((N, L), generator=g, device=dev) > 0.5
        allowed[:, 0] = True
        allowed[1, 1:] = False  # a proposal whose CLS row sees only itself
        bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min).float()
    got = clip_attention(q, k, v, bias, H, hd**-0.5)
    close(got, reference_clip_attention(q, k, v, bias, H, hd**-0.5), dtype)


@pytest.mark.parametrize("bf16", ["0", "1"])
@pytest.mark.parametrize("window", [(0, 0, 48, 40), (7, 3, 30, 55), (70, 0, 20, 96)])
def test_pass1_stats_half(dev, monkeypatch, bf16, window):
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", bf16)
    g = torch.Generator(device=dev).manual_seed(5)
    B, n, C = 7, 40, 96
    tmp = torch.randn((B, n, C), generator=g, device=dev) * 2.0
    Wy = _composed_axis_weights(C, n, 128, 115, window[0], window[2], dev)
    s, r, c = pass1_stats_half(tmp, Wy, window, 0.0, 1.0)
    dt = torch.bfloat16 if bf16 == "1" else torch.float32
    s0, r0, c0 = reference_pass1_stats_half(tmp.to(dt), Wy.to(dt), window, 0.0, 1.0)
    assert float((s - s0).abs().max()) <= 1e-3
    assert float((r != r0).float().mean()) <= 0.01 and float((c != c0).float().mean()) <= 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd,block_q,block_k", [(8, 8, 16, 16), (8, 16, 32, 64), (14, 80, 196, 196), (64, 80, 256, 512)])
def test_flash_attention_rel_pos(dev, dtype, G, hd, block_q, block_k):
    """K9: pre-scaled q, rel terms in q's dtype (widened by the wrapper)."""
    g = torch.Generator(device=dev).manual_seed(G + hd)
    BH, S = 3 if G < 64 else 2, G * G
    q, k, v = (torch.randn((BH, S, hd), generator=g, device=dev).to(dtype) for _ in range(3))
    q = (q.float() * hd**-0.5).to(dtype)
    rh, rw = ((torch.randn((BH, S, G), generator=g, device=dev) * 0.5).to(dtype) for _ in range(2))
    before = flash_attention_rel_pos.launches
    got = flash_attention_rel_pos(q, k, v, rh, rw, G, block_q=block_q, block_k=block_k)
    assert flash_attention_rel_pos.launches == before + 1
    assert got.dtype == dtype
    close(got, reference_attention_rel_pos(q, k, v, rh.float(), rw.float(), G, 1.0), dtype)


@pytest.mark.parametrize("bf16", ["0", "1"])
@pytest.mark.parametrize(
    "n,n2,C,window",
    [(16, 16, 64, (0, 0, 48, 40)), (40, 33, 96, (7, 3, 30, 55)), (256, 256, 300, (17, 5, 200, 250))],
)
def test_pass1_stats_full(dev, monkeypatch, bf16, n, n2, C, window):
    """K10 against half_transform + the plain stats: ragged n (padding of the
    column block), n2 and C, windows off the origin."""
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", bf16)
    g = torch.Generator(device=dev).manual_seed(n + C)
    B = 7
    low = torch.randn((B, n, n2), generator=g, device=dev) * 2.0
    Wy = _composed_axis_weights(C, n, 128, 115, window[0], window[2], dev)
    WxT = _composed_axis_weights(C, n2, 128, 100, window[1], window[3], dev).T.contiguous()
    before = pass1_stats.launches
    s, r, c = pass1_stats(low, WxT, Wy, window, 0.0, 1.0)
    assert pass1_stats.launches == before + 1
    dt = torch.bfloat16 if bf16 == "1" else torch.float32
    s0, r0, c0 = reference_pass1_stats_half(half_transform(low, WxT), Wy.to(dt), window, 0.0, 1.0)
    assert bool(r0.any())
    assert float((s - s0).abs().max()) <= 1e-3
    assert float((r != r0).float().mean()) <= 0.01 and float((c != c0).float().mean()) <= 0.01


DEC_B, DEC_S, DEC_C, DEC_T = 3, 300, 64, 7


def dec_operands(dev, dtype, Cq, heads, tp, seed, GT2=None):
    """Random decoder-kernel operands: image streams in ``dtype``, token-side
    weights f32, off = -1e30 on the padding lanes t >= T."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, std=0.5):
        return torch.randn(shape, generator=g, device=dev) * std

    GT = heads * tp
    off = r(DEC_B, heads, tp)
    off[:, :, DEC_T:] = -1e30
    return dict(w=r(DEC_B, Cq, GT, std=0.3), off=off.reshape(DEC_B, GT), vo=r(DEC_B, GT, DEC_C).to(dtype),
                const=r(DEC_C), ln_scale=1.0 + r(DEC_C, std=0.1), ln_bias=r(DEC_C, std=0.1)), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,tp", [(2, 8), (8, 16)])
@pytest.mark.parametrize("site", ["generic_pe", "shared"])
def test_i2t_ln_update(dev, dtype, heads, tp, site):
    """K7 with pe on per-prompt keys, and at the shared site with broadcast
    [1, S, .] qside/base and Cq = 32 != C = 64."""
    Cq = DEC_C if site == "generic_pe" else 32
    ops, r = dec_operands(dev, dtype, Cq, heads, tp, heads * tp)
    if site == "generic_pe":
        qside = r(DEC_B, DEC_S, DEC_C).to(dtype)
        base, pe = qside, r(1, DEC_S, DEC_C).to(dtype)
    else:
        qside, base, pe = r(1, DEC_S, Cq).to(dtype), r(1, DEC_S, DEC_C).to(dtype), None
    before = i2t_ln_update.launches
    got = i2t_ln_update(qside, base, **ops, heads=heads, tp=tp, pe=pe)
    assert i2t_ln_update.launches == before + 1
    close(got, reference_i2t_ln_update(qside, base, **ops, heads=heads, tp=tp, pe=pe), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("GT,scale", [(16, 1.0), (128, 1.0), (64, 40.0)])
def test_t2i_ctx(dev, dtype, GT, scale):
    """K8, including scores x40 where the online softmax must hold."""
    g = torch.Generator(device=dev).manual_seed(GT)
    keys = (torch.randn((DEC_B, DEC_S, DEC_C), generator=g, device=dev) * 0.5).to(dtype)
    pe = (torch.randn((1, DEC_S, DEC_C), generator=g, device=dev) * 0.5).to(dtype)
    qw = torch.randn((DEC_B, DEC_C, GT), generator=g, device=dev) * 0.3 * scale
    qw[:, :, 7::8] = 0.0  # padding columns
    before = t2i_ctx.launches
    got = t2i_ctx(keys, pe, qw)
    assert t2i_ctx.launches == before + 1
    close(got, reference_t2i_ctx(keys, pe, qw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,tp", [(2, 8), (8, 16)])
@pytest.mark.parametrize("shared", [True, False])
def test_i2t_ln_then_t2i(dev, dtype, heads, tp, shared):
    """K3 in both modes: keys' and ctx against the plain version."""
    Cq = 32 if shared else DEC_C
    ops, r = dec_operands(dev, dtype, Cq, heads, tp, 7 * heads + tp)
    qside = r(1 if shared else DEC_B, DEC_S, Cq).to(dtype)
    base = r(1, DEC_S, DEC_C).to(dtype) if shared else qside
    pe = r(1, DEC_S, DEC_C).to(dtype)
    qw = r(DEC_B, DEC_C, heads * tp, std=0.3)
    before = i2t_ln_then_t2i.launches
    keys, ctx = i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=heads, tp=tp, shared_qside=shared)
    assert i2t_ln_then_t2i.launches == before + 1
    keys0, ctx0 = reference_i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=heads, tp=tp,
                                            shared_qside=shared)
    close(keys, keys0, dtype)
    close(ctx, ctx0, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g_,C,c4,c8,m", [(5, 32, 8, 4, 3), (16, 64, 16, 8, 1), (9, 128, 32, 16, 3)])
def test_upscale_hyper(dev, dtype, g_, C, c4, c8, m):
    """K4 at ragged grids (g*g not a multiple of the 16-pixel tile)."""
    gen = torch.Generator(device=dev).manual_seed(C + g_)

    def r(*shape, std=0.5):
        return torch.randn(shape, generator=gen, device=dev) * std

    args = (r(DEC_B, g_ * g_, C).to(dtype), r(C, 4 * c4, std=C**-0.5), r(c4), 1.0 + r(c4, std=0.1), r(c4, std=0.1),
            r(c4, 4 * c8, std=c4**-0.5), r(c8), r(DEC_B, m, c8))
    before = upscale_hyper.launches
    got = upscale_hyper(*args)
    assert upscale_hyper.launches == before + 1
    assert got.shape == (DEC_B, m, 4 * g_, 4 * g_)
    close(got, reference_upscale_hyper(*args), dtype)


def test_wrappers_raise_on_bad_input(dev):
    q = torch.zeros((2, 64, 24), device=dev)  # unsupported head dim
    r = torch.zeros((2, 64, 8), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_windowed_fused(q, q, q, r, r, 8, 1.0)
    q = torch.zeros((2, 64, 32), device=dev)
    with pytest.raises(TypeError, match="f32"):
        flash_attention_fused(q, q, q, r.half(), r.half(), 8, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fused(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, r, r, 8, 1.0)
    with pytest.raises(ValueError, match="block_k"):  # K9: the TPU tiles as the reference asserts them
        flash_attention_rel_pos(q, q, q, r, r, 8, block_q=16, block_k=12)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_rel_pos(q[..., :12].contiguous(), q[..., :12].contiguous(), q[..., :12].contiguous(), r, r,
                                8, block_q=16, block_k=16)
    low = torch.zeros((2, 4096, 16), device=dev)  # K10: the column block does not fit in shared memory
    with pytest.raises(ValueError, match="shared memory"):
        pass1_stats(low, torch.zeros((16, 64), device=dev), torch.zeros((64, 4096), device=dev), (0, 0, 8, 8), 0.0, 1.0)
    with pytest.raises(ValueError, match="Wy"):
        pass1_stats(low, torch.zeros((16, 64), device=dev), torch.zeros((64, 16), device=dev), (0, 0, 8, 8), 0.0, 1.0)
    ops, r = dec_operands(dev, torch.float32, DEC_C, 2, 8, 0)
    keys = r(DEC_B, DEC_S, DEC_C)
    with pytest.raises(ValueError, match="contiguous"):
        i2t_ln_update(keys.transpose(0, 1).contiguous().transpose(0, 1), keys, **ops, heads=2, tp=8)
    with pytest.raises(ValueError, match="base"):
        i2t_ln_update(keys, keys[:, :-1].contiguous(), **ops, heads=2, tp=8)
    with pytest.raises(ValueError, match="unsupported widths"):
        t2i_ctx(keys, keys[:1], r(DEC_B, DEC_C, 6))
    with pytest.raises(TypeError, match="bf16 or f32"):
        i2t_ln_then_t2i(keys.half(), keys.half(), keys[:1].half(), **ops, qw_next=r(DEC_B, DEC_C, 16), heads=2,
                        tp=8, shared_qside=False)
    with pytest.raises(ValueError, match="hyper"):
        upscale_hyper(r(2, 16, 32), r(32, 32), r(8), r(8), r(8), r(8, 16), r(4), r(3, 3, 4))
    with pytest.raises(ValueError, match="shared memory"):  # f32 w1 at full width does not fit
        upscale_hyper(r(1, 16, 256), r(256, 256), r(64), r(64), r(64), r(64, 128), r(32), r(1, 3, 32))


# ---- the decoder kernels' tensor-core variants (bf16 at SAM's widths) ----

TC_C, TC_HEADS, TC_TP = 256, 8, 8
BF16 = torch.bfloat16


def close_tc(got, want):
    """The kernel check's attention bar."""
    g, w = got.float().flatten(), want.float().flatten()
    assert torch.isfinite(g).all()
    cos = float(g @ w / (g.norm() * w.norm()))
    rel = float((g - w).abs().mean() / w.abs().mean())
    assert cos >= 0.999 and rel < 0.02, (cos, rel)


def tc_operands(dev, B, S, shared, seed, per_prompt_pe=False, qw_scale=1.0):
    """K3 operands in one of the two forms the tensor-core kernel takes."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, std=0.5, dtype=BF16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    f32, GT = torch.float32, TC_HEADS * TC_TP
    Cq = TC_C // 2 if shared else TC_C
    off = r(B, TC_HEADS, TC_TP, dtype=f32)
    off[:, :, 7:] = -1e30
    ops = dict(w=r(B, Cq, GT, std=2 * Cq**-0.5, dtype=f32), off=off.reshape(B, GT), vo=r(B, GT, TC_C),
               const=r(TC_C, std=0.1, dtype=f32), ln_scale=1.0 + r(TC_C, std=0.1, dtype=f32),
               ln_bias=r(TC_C, std=0.1, dtype=f32))
    qside = r(1 if shared else B, S, Cq)
    base = r(1, S, TC_C) if shared else qside
    pe = r(B if per_prompt_pe else 1, S, TC_C)
    qw = r(B, TC_C, GT, std=2 * TC_C**-0.5 * qw_scale, dtype=f32)
    qw[:, :, 7::8] = 0.0
    return qside, base, pe, ops, qw


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("B,S,per_prompt_pe,qw_scale,kind", [
    (3, 64, False, 1.0, "wgmma"),       # one tile
    (5, 4096, False, 1.0, "wgmma"),     # 64 tiles over row splits the last of which is short
    (5, 4096, True, 40.0, "wgmma"),     # per-prompt pe; large logits in the online softmax
    (2, 1024 + 32, False, 1.0, "cuda-core"),  # ragged S stays on the CUDA-core kernel
])
def test_i2t_ln_then_t2i_tensor_core(dev, shared, B, S, per_prompt_pe, qw_scale, kind):
    qside, base, pe, ops, qw = tc_operands(dev, B, S, shared, 31 * B + S, per_prompt_pe, qw_scale)
    Cq = qside.shape[-1]
    assert decoder_attn.variant(decoder_attn.PASS, BF16, S, Cq, TC_C, 8, 8, 64, not shared, not shared)[0] == kind
    before = i2t_ln_then_t2i.launches
    keys, ctx = i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=8, tp=8, shared_qside=shared)
    assert i2t_ln_then_t2i.launches == before + 1
    keys0, ctx0 = reference_i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=8, tp=8, shared_qside=shared)
    close_tc(keys, keys0)
    close_tc(ctx, ctx0)
    again = i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=8, tp=8, shared_qside=shared)
    assert torch.equal(keys, again[0]) and torch.equal(ctx, again[1])  # no atomics: bit-equal runs


@pytest.mark.parametrize("site", ["per_prompt", "shared"])
@pytest.mark.parametrize("B,S", [(3, 64), (5, 4096)])
def test_i2t_ln_update_tensor_core(dev, site, B, S):
    """K7 on the tensor-core kernel: the keys scored with pe, and the
    shared layer-0 form (a 128-wide score side, no pe)."""
    shared = site == "shared"
    qside, base, pe, ops, _ = tc_operands(dev, B, S, shared, 17 * B + S)
    pe = None if shared else pe
    assert decoder_attn.variant(decoder_attn.I2T, BF16, S, qside.shape[-1], TC_C, 8, 8, 4, not shared,
                                not shared)[0] == "wgmma"
    got = i2t_ln_update(qside, base, **ops, heads=8, tp=8, pe=pe)
    close_tc(got, reference_i2t_ln_update(qside, base, **ops, heads=8, tp=8, pe=pe))
    assert torch.equal(got, i2t_ln_update(qside, base, **ops, heads=8, tp=8, pe=pe))


@pytest.mark.parametrize("B,S,per_prompt_pe,qw_scale", [(3, 64, False, 1.0), (5, 4096, False, 40.0),
                                                        (5, 4096, True, 1.0)])
def test_t2i_ctx_tensor_core(dev, B, S, per_prompt_pe, qw_scale):
    keys, _, pe, _, qw = tc_operands(dev, B, S, False, 13 * B + S, per_prompt_pe, qw_scale)
    assert decoder_attn.variant(decoder_attn.T2I, BF16, S, TC_C, TC_C, 1, 8, 64, False, False)[0] == "wgmma"
    got = t2i_ctx(keys, pe, qw)
    close_tc(got, reference_t2i_ctx(keys, pe, qw))
    assert torch.equal(got, t2i_ctx(keys, pe, qw))


@pytest.mark.parametrize("m,kind", [(1, "wgmma"), (3, "wgmma"), (2, "cuda-core")])
@pytest.mark.parametrize("B,g_", [(3, 8), (5, 64), (3, 10)])
def test_upscale_hyper_tensor_core(dev, m, kind, B, g_):
    """K4 at SAM's widths: one tile (g = 8), the production grid with a B
    that leaves the persistent blocks uneven, and a grid whose last tile is
    ragged (g = 10: 100 pixels); m = 2 stays on the CUDA-core kernel. The
    kernel check's K4 bar, and bit-equal runs."""
    gen = torch.Generator(device=dev).manual_seed(100 * m + g_)

    def r(*shape, std=0.5, dtype=BF16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    f32 = torch.float32
    args = (r(B, g_ * g_, 256), r(256, 256, std=1 / 16), r(64, std=0.1, dtype=f32), 1.0 + r(64, std=0.1, dtype=f32),
            r(64, std=0.1, dtype=f32), r(64, 128, std=1 / 8), r(32, std=0.1, dtype=f32), r(B, m, 32))
    assert upscale_mod.variant(BF16, 256, 64, 32, m)[0] == kind
    before = upscale_hyper.launches
    got = upscale_hyper(*args)
    assert upscale_hyper.launches == before + 1
    want = reference_upscale_hyper(*args)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.1
    assert float(((got > 0) == (want > 0)).float().mean()) > 0.995
    assert torch.equal(got, upscale_hyper(*args))


def test_variant_functions_mirror_the_c_dispatch(dev):
    """``variant`` (plain Python, also tested on the CPU) against the C
    entry points' own dispatch and shared-memory sizes."""
    lib = _build.library()
    for mode in (decoder_attn.I2T, decoder_attn.T2I, decoder_attn.PASS):
        for dtype in (BF16, torch.float32):
            for S in (32, 64, 4064, 4096):
                for Cq, C in ((256, 256), (128, 256), (128, 128), (64, 64)):
                    for heads, tp in ((8, 8), (4, 16), (2, 8)):
                        for GT2 in (64, 16):
                            for add_pe, same_base in ((True, True), (False, False), (True, False), (False, True)):
                                if mode == decoder_attn.T2I and Cq != C:
                                    continue
                                kind, smem = decoder_attn.variant(mode, dtype, S, Cq, C, heads, tp, GT2, add_pe,
                                                                  same_base)
                                takes = lib.hgl_decoder_attn_tc_takes(mode, S, Cq, C, heads, tp, GT2, int(add_pe),
                                                                      int(same_base), int(dtype == BF16))
                                assert (kind == "wgmma") == bool(takes)
                                if takes:
                                    assert smem == lib.hgl_decoder_attn_tc_smem()
    for dtype in (BF16, torch.float32):
        for C, c4, c8 in ((256, 64, 32), (128, 32, 16), (256, 64, 16)):
            for m in (1, 2, 3, 4):
                kind, smem = upscale_mod.variant(dtype, C, c4, c8, m)
                takes = lib.hgl_upscale_hyper_tc_takes(C, c4, c8, m, int(dtype == BF16))
                assert (kind == "wgmma") == bool(takes)
                if takes:
                    assert smem == lib.hgl_upscale_hyper_tc_smem()


# ---- K5 and K6 on their tensor-core kernels (bf16), beside the CUDA-core ones ----


def _k5_inputs(dev, B, n, C, window, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    tmp = torch.randn((B, n, C), generator=g, device=dev) * 2.0
    Wy = _composed_axis_weights(C, n, 2 * C, 2 * C - 26, window[0], window[2], dev)
    return tmp, Wy


K5_SHAPES = [
    # B, n, C, window (y0, x0, dh, dw)
    (7, 256, 640, (0, 0, 480, 640)),     # the RefCOCO window; C = 640 is five strips, not a multiple of 128 x 2
    (3, 256, 1024, (159, 239, 321, 401)),  # a PhraseCut layer-1 crop: y0, x0 no multiples of 8, four of eight strips
    (1, 256, 640, (0, 0, 480, 640)),     # B = 1
    (5, 64, 200, (0, 0, 128, 128)),      # n < 256; the window ends on a tile edge and a strip edge; C % 128 = 72
    (5, 16, 136, (3, 5, 61, 40)),        # one wgmma K step; a window narrower than one strip, inside one row tile
    (4, 48, 320, (63, 127, 2, 2)),       # a 2 x 2 window across a tile corner: two row tiles, two strips
    (4, 112, 264, (130, 250, 134, 14)),  # the last strip holds 8 live columns; the last row tile is ragged
    (2, 256, 72, (10, 0, 50, 72)),       # C smaller than one strip
]


@pytest.mark.parametrize("bf16", ["1", "0"])
@pytest.mark.parametrize("B,n,C,window", K5_SHAPES)
def test_pass1_stats_half_both_kernels(dev, monkeypatch, bf16, B, n, C, window):
    """Short and ragged windows: bf16 on the tensor-core kernel, f32 on the
    CUDA-core kernel, each against the plain version: stability |d| <= 1e-3
    (bf16) or 1e-4 (f32), box edges within 1 px (bf16) or equal (f32), and no
    flag outside the window at all."""
    from hybridgl_tpu_torch.kernels import pass1_stats as mod
    from hybridgl_tpu_torch.kernels.masks import box_from_profiles

    monkeypatch.setenv("HYBRIDGL_STATS_BF16", bf16)
    dt = torch.bfloat16 if bf16 == "1" else torch.float32
    assert mod.variant(dt, n, C) == ("wgmma" if bf16 == "1" else "cuda-core")
    tmp, Wy = _k5_inputs(dev, B, n, C, window, seed=n + C)
    before = (pass1_stats_half.launches, pass1_stats_half.tc_launches)
    s, r, c = pass1_stats_half(tmp, Wy, window, 0.0, 1.0)
    torch.cuda.synchronize()
    assert pass1_stats_half.launches == before[0] + 1
    assert pass1_stats_half.tc_launches == before[1] + int(bf16 == "1")
    s0, r0, c0 = reference_pass1_stats_half(tmp.to(dt), Wy.to(dt), window, 0.0, 1.0)
    assert r0.any() and c0.any()
    assert torch.isfinite(s).all()
    assert float((s - s0).abs().max()) <= (1e-3 if bf16 == "1" else 1e-4)
    db = float((box_from_profiles(r, c) - box_from_profiles(r0, c0)).abs().max())
    assert db <= (1.0 if bf16 == "1" else 0.0)
    y0, x0, dh, dw = window
    idx = torch.arange(C, device=dev)
    assert not r[:, (idx < y0) | (idx >= y0 + dh)].any()
    assert not c[:, (idx < x0) | (idx >= x0 + dw)].any()


@pytest.mark.parametrize("axis", ["rows", "columns"])
@pytest.mark.parametrize("sign", ["outside", "inside"])
def test_pass1_stats_half_tensor_core_masks_the_window(dev, axis, sign):
    """Logits that pass the threshold only outside the window (along one axis)
    must raise nothing: no count, no row flag from a dead column, no column
    flag from a dead row. With the signs swapped the flags are exactly the window."""
    B, n, C, window = 3, 32, 200, (21, 70, 90, 61)
    y0, x0, dh, dw = window
    idx = torch.arange(C, device=dev)
    in_rows, in_cols = (idx >= y0) & (idx < y0 + dh), (idx >= x0) & (idx < x0 + dw)
    live = in_rows if axis == "rows" else in_cols
    pattern = torch.where(live if sign == "inside" else ~live, 1.0, -1.0)
    Wy = torch.ones((C, n), device=dev)
    tmp = torch.ones((B, n, C), device=dev)
    if axis == "rows":
        Wy = Wy * pattern[:, None]
    else:
        tmp = tmp * pattern[None, None, :]
    s, r, c = pass1_stats_half(tmp.bfloat16(), Wy.bfloat16(), window, 0.0, 1.0)
    torch.cuda.synchronize()
    if sign == "outside":
        assert not r.any() and not c.any() and float(s.abs().max()) == 0.0
    else:
        assert torch.equal(r, in_rows.expand(B, C)) and torch.equal(c, in_cols.expand(B, C))
        assert torch.equal(s, torch.ones_like(s))  # |logit| = n = 32 > offset: hi = lo = dh * dw


def test_pass1_stats_half_tensor_core_repeats_and_refuses(dev):
    """Integer atomics: the same call gives the same result bit for bit; a
    misaligned operand is refused."""
    tmp, Wy = _k5_inputs(dev, 6, 256, 640, (0, 0, 480, 640), seed=1)
    tmp, Wy = tmp.bfloat16(), Wy.bfloat16()
    first = pass1_stats_half(tmp, Wy, (0, 0, 480, 640), 0.0, 1.0)
    for _ in range(3):
        again = pass1_stats_half(tmp, Wy, (0, 0, 480, 640), 0.0, 1.0)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    buf = torch.zeros(2 * 32 * 64 + 1, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pass1_stats_half(buf[1:].view(2, 32, 64), torch.zeros((64, 32), device=dev, dtype=torch.bfloat16),
                         (0, 0, 64, 64), 0.0, 1.0)


def _k6_inputs(dev, N, H, L, hd, with_bias, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((N * H, L, hd), generator=g, device=dev).bfloat16() for _ in range(3))
    bias = None
    if with_bias:
        allowed = torch.rand((N, L), generator=g, device=dev) > 0.5
        allowed[:, 0] = True
        allowed[1, 1:] = False  # a proposal whose CLS row sees only itself
        bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min).float()
    return q, k, v, bias


def _attention_bar(got, want):
    got, want = got.float().flatten(), want.float().flatten()
    assert torch.isfinite(got).all()
    assert float(got @ want / (got.norm() * want.norm())) >= 0.999
    assert float((got - want).abs().mean() / want.abs().mean()) < 0.02


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("N,H,L,hd", [
    (128, 12, 197, 64),  # ViT-B/16 at 2P = 128 streams: four query tiles of 50 rows, four key tiles
    (16, 12, 50, 64),    # ViT-B/32: one query tile, one key tile
    (5, 2, 17, 64),      # the tiny presets' length at a tensor-core head dim
    (5, 2, 64, 64),      # exactly one full key tile
    (5, 2, 65, 80),      # one key past a tile; hd = 80
    (5, 2, 200, 80),
    (5, 2, 256, 64),     # the longest resident sequence
])
def test_clip_attention_tensor_core(dev, N, H, L, hd, with_bias):
    """bf16 at hd 64 / 80 and L <= 256 on the resident tensor-core kernel, at
    the kernel check's attention bar over the whole output and over query row 0
    alone: only row 0 is biased, and a cosine over all rows would hide it."""
    from hybridgl_tpu_torch.kernels import clip_attention as mod

    assert mod.variant(torch.bfloat16, L, hd) == "wgmma"
    q, k, v, bias = _k6_inputs(dev, N, H, L, hd, with_bias, seed=L + hd)
    before = (clip_attention.launches, clip_attention.tc_launches)
    got = clip_attention(q, k, v, bias, H, hd**-0.5)
    torch.cuda.synchronize()
    assert (clip_attention.launches, clip_attention.tc_launches) == (before[0] + 1, before[1] + 1)
    want = reference_clip_attention(q.float(), k.float(), v.float(), bias, H, hd**-0.5)
    _attention_bar(got, want)
    _attention_bar(got[:, 0], want[:, 0])
    _attention_bar(got[:, 1:], want[:, 1:])
    if with_bias:  # the masked stream's CLS row attends to itself alone: its output is v[0]
        for h in range(H):
            assert torch.allclose(got[H + h, 0].float(), v[H + h, 0].float(), atol=1e-2)


@pytest.mark.parametrize("L,hd", [(50, 64), (17, 64), (130, 80)])
def test_clip_attention_resident_short_sequences_under_load(dev, L, hd):
    """One to three key tiles with thousands of stream-heads in flight, so that
    the K/V copies really lag the first product; every element is held."""
    q, k, v, bias = _k6_inputs(dev, 200, 12, L, hd, True, seed=L)
    want = reference_clip_attention(q.float(), k.float(), v.float(), bias, 12, hd**-0.5)
    for _ in range(3):
        got = clip_attention(q, k, v, bias, 12, hd**-0.5).float()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) < 0.05


@pytest.mark.parametrize("dtype,L,hd,kind", [
    (torch.float32, 197, 64, "cuda-core"), (torch.bfloat16, 197, 32, "cuda-core"),
    (torch.bfloat16, 257, 64, "cuda-core"), (torch.float32, 50, 80, "cuda-core"),
])
def test_clip_attention_cuda_core_kernel_kept(dev, dtype, L, hd, kind):
    """f32, the other head dims and L > 256 (ViT-L/14's 257) stay on the
    CUDA-core kernel; row 0 on its own here too."""
    from hybridgl_tpu_torch.kernels import clip_attention as mod

    assert mod.variant(dtype, L, hd) == kind
    q, k, v, bias = _k6_inputs(dev, 5, 2, L, hd, True, seed=L)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = clip_attention.tc_launches
    got = clip_attention(q, k, v, bias, 2, hd**-0.5)
    assert clip_attention.tc_launches == before
    want = reference_clip_attention(q, k, v, bias, 2, hd**-0.5)
    close(got, want, dtype)
    close(got[:, 0], want[:, 0], dtype)


def test_k5_k6_variant_functions_mirror_the_c_dispatch(dev):
    from hybridgl_tpu_torch.kernels import clip_attention as k6
    from hybridgl_tpu_torch.kernels import pass1_stats as k5

    lib = _build.library()
    for n in (8, 16, 40, 48, 200, 256, 272, 512):
        for C in (4, 8, 72, 100, 640, 1024):
            assert (k5.variant(BF16, n, C) == "wgmma") == bool(lib.hgl_pass1_stats_tc_takes(n, C))
            assert k5.variant(torch.float32, n, C) == "cuda-core"
    assert lib.hgl_pass1_stats_tc_smem(256) == 256 * 768 <= 227 * 1024
    for L in (1, 17, 50, 197, 256, 257, 512):
        for hd in (16, 32, 64, 80):
            assert (k6.variant(BF16, L, hd) == "wgmma") == bool(lib.hgl_cls_tc_takes(L, hd))
            assert k6.variant(torch.float32, L, hd) == "cuda-core"


# ---- K10 on its tensor-core kernel (bf16), beside the CUDA-core one ----


K10_SHAPES = [
    # B, n, n2, C, window (y0, x0, dh, dw)
    (7, 256, 256, 640, (0, 0, 480, 640)),      # the check's RefCOCO shape: four tiles of low, five strips
    (3, 256, 256, 1024, (17, 5, 451, 633)),    # the reference check's window; the last three strips leave at once
    (1, 256, 256, 640, (0, 0, 480, 640)),      # B = 1
    (5, 16, 16, 136, (3, 5, 61, 40)),          # one wgmma K step in both products; one tile of low, mostly padding
    (5, 48, 32, 320, (63, 127, 2, 2)),         # n2 < n; a 2 x 2 window across a tile corner
    (4, 240, 256, 264, (130, 250, 134, 14)),   # the last tile of low holds 48 rows; the last strip 8 live columns
    (4, 64, 256, 200, (0, 0, 128, 128)),       # n2 > n: the staged operands outgrow the Wy buffers of n alone
    (2, 128, 112, 8, (0, 0, 8, 8)),            # C = 8: one chunk of one strip; one tile per warpgroup
    (3, 192, 16, 72, (10, 0, 50, 72)),         # three tiles of low: the warpgroups take two and one
]


def _k10_inputs(dev, B, n, n2, C, window, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    low = torch.randn((B, n, n2), generator=g, device=dev) * 2.0
    Wy = _composed_axis_weights(C, n, 2 * C, 2 * C - 26, window[0], window[2], dev)
    WxT = _composed_axis_weights(C, n2, 2 * C, 2 * C - 10, window[1], window[3], dev).T.contiguous()
    return low, WxT, Wy


@pytest.mark.parametrize("bf16", ["1", "0"])
@pytest.mark.parametrize("B,n,n2,C,window", K10_SHAPES)
def test_pass1_stats_full_both_kernels(dev, monkeypatch, bf16, B, n, n2, C, window):
    """Short and ragged shapes: bf16 on the tensor-core kernel, f32 on the
    CUDA-core kernel, each against half_transform + the plain stats: stability
    |d| <= 1e-3 (bf16) or 1e-4 (f32), box edges within 1 px (bf16) or equal
    (f32), and no flag outside the window at all."""
    from hybridgl_tpu_torch.kernels import pass1_stats as mod
    from hybridgl_tpu_torch.kernels.masks import box_from_profiles

    monkeypatch.setenv("HYBRIDGL_STATS_BF16", bf16)
    dt = torch.bfloat16 if bf16 == "1" else torch.float32
    assert mod.variant_full(dt, n, n2, C) == ("wgmma" if bf16 == "1" else "cuda-core")
    low, WxT, Wy = _k10_inputs(dev, B, n, n2, C, window, seed=n + n2 + C)
    before = (pass1_stats.launches, pass1_stats.tc_launches)
    s, r, c = pass1_stats(low, WxT, Wy, window, 0.0, 1.0)
    torch.cuda.synchronize()
    assert pass1_stats.launches == before[0] + 1
    assert pass1_stats.tc_launches == before[1] + int(bf16 == "1")
    s0, r0, c0 = reference_pass1_stats_half(half_transform(low, WxT), Wy.to(dt), window, 0.0, 1.0)
    assert r0.any() and c0.any()
    assert torch.isfinite(s).all()
    assert float((s - s0).abs().max()) <= (1e-3 if bf16 == "1" else 1e-4)
    db = float((box_from_profiles(r, c) - box_from_profiles(r0, c0)).abs().max())
    assert db <= (1.0 if bf16 == "1" else 0.0)
    y0, x0, dh, dw = window
    idx = torch.arange(C, device=dev)
    assert not r[:, (idx < y0) | (idx >= y0 + dh)].any()
    assert not c[:, (idx < x0) | (idx >= x0 + dw)].any()


@pytest.mark.parametrize("n,n2", [(32, 48), (256, 256), (240, 16)])
def test_pass1_stats_full_tensor_core_equals_k5_on_its_own_tmp(dev, n, n2):
    """With small integer operands every f32 sum is exact, so the strip the
    kernel computes is the tmp that half_transform computes bit for bit, and
    K10 must equal K5 on that tmp exactly: counts, row flags, column flags. A
    wrong index in the fragment-to-strip store cannot pass."""
    B, C, window = 4, 392, (9, 130, 300, 201)
    g = torch.Generator(device=dev).manual_seed(n * n2)
    low = torch.randint(-3, 4, (B, n, n2), generator=g, device=dev).float()
    WxT = torch.randint(-2, 3, (n2, C), generator=g, device=dev).float()
    WxT = WxT * (torch.rand((n2, C), generator=g, device=dev) < 0.1)  # sparse: |tmp| stays under 256, exact in bf16
    Wy = torch.randint(-2, 3, (C, n), generator=g, device=dev).float()
    tmp = half_transform(low, WxT)
    assert torch.equal(tmp.float(), low @ WxT)  # nothing was rounded
    before = pass1_stats.tc_launches
    got = pass1_stats(low, WxT, Wy, window, 0.5, 3.0)
    want = pass1_stats_half(tmp, Wy, window, 0.5, 3.0)
    plain = reference_pass1_stats_half(tmp, Wy.bfloat16(), window, 0.5, 3.0)
    torch.cuda.synchronize()
    assert pass1_stats.tc_launches == before + 1
    assert plain[1].any() and plain[2].any()
    for a, b_, p in zip(got, want, plain):
        assert torch.equal(a, b_) and torch.equal(a, p)


@pytest.mark.parametrize("axis", ["rows", "columns", "hot column"])
@pytest.mark.parametrize("sign", ["outside", "inside"])
def test_pass1_stats_full_tensor_core_masks_the_window(dev, axis, sign):
    """Logits that pass the threshold only outside the window (along one axis)
    must raise nothing; with the signs swapped the flags are exactly the
    window. "hot column": WxT is positive in one column only (inside the window,
    or just outside it), so the column flags are that column or nothing."""
    B, n, n2, C, window = 3, 32, 48, 200, (21, 70, 90, 61)
    y0, x0, dh, dw = window
    idx = torch.arange(C, device=dev)
    in_rows, in_cols = (idx >= y0) & (idx < y0 + dh), (idx >= x0) & (idx < x0 + dw)
    low = torch.ones((B, n, n2), device=dev)
    Wy = torch.ones((C, n), device=dev)
    WxT = torch.ones((n2, C), device=dev)
    if axis == "hot column":
        hot = x0 + 37 if sign == "inside" else x0 + dw  # the first column past the window
        WxT = torch.where(idx == hot, 1.0, -1.0)[None, :].expand(n2, C).contiguous()
        want_cols = in_cols & (idx == hot)
        want_rows = in_rows if sign == "inside" else torch.zeros_like(in_rows)
    else:
        live = in_rows if axis == "rows" else in_cols
        pattern = torch.where(live if sign == "inside" else ~live, 1.0, -1.0)
        if axis == "rows":
            Wy = Wy * pattern[:, None]
        else:
            WxT = WxT * pattern[None, :]
        want_rows = in_rows if sign == "inside" else torch.zeros_like(in_rows)
        want_cols = in_cols if sign == "inside" else torch.zeros_like(in_cols)
    before = pass1_stats.tc_launches
    s, r, c = pass1_stats(low, WxT, Wy, window, 0.0, 1.0)
    torch.cuda.synchronize()
    assert pass1_stats.tc_launches == before + 1
    assert torch.equal(r, want_rows.expand(B, C)) and torch.equal(c, want_cols.expand(B, C))
    # |logit| = n * n2 > offset everywhere: hi = lo wherever anything passes
    assert torch.equal(s, torch.full_like(s, float(bool(want_rows.any()))))


def test_pass1_stats_full_tensor_core_repeats_and_refuses(dev):
    """Integer atomics: the same call gives the same result bit for bit, with
    many blocks in flight; n = 200 and f32 stay off the tensor-core kernel."""
    low, WxT, Wy = _k10_inputs(dev, 96, 256, 256, 640, (0, 0, 480, 640), seed=1)
    first = pass1_stats(low, WxT, Wy, (0, 0, 480, 640), 0.0, 1.0)
    for _ in range(3):
        again = pass1_stats(low, WxT, Wy, (0, 0, 480, 640), 0.0, 1.0)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    before = pass1_stats.tc_launches
    low, WxT, Wy = _k10_inputs(dev, 2, 200, 256, 640, (0, 0, 480, 640), seed=2)
    pass1_stats(low, WxT, Wy, (0, 0, 480, 640), 0.0, 1.0)
    assert pass1_stats.tc_launches == before


def test_k10_variant_function_mirrors_the_c_dispatch(dev):
    from hybridgl_tpu_torch.kernels import pass1_stats as k10

    lib = _build.library()
    for n in (8, 16, 48, 200, 256, 272):
        for n2 in (8, 16, 40, 240, 256, 288):
            for C in (4, 8, 100, 640):
                assert (k10.variant_full(BF16, n, n2, C) == "wgmma") == bool(lib.hgl_pass1_stats_full_tc_takes(n, n2, C))
                assert k10.variant_full(torch.float32, n, n2, C) == "cuda-core"
    assert lib.hgl_pass1_stats_full_tc_smem(256, 256) == 256 * 768 <= 227 * 1024
    assert lib.hgl_pass1_stats_full_tc_smem(64, 256) == 64 * 256 + 512 * 256


# ---- K3 with more than 8 tokens a head at SAM's width: the split route ----


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("B,T", [(1, 9), (3, 12)])
def test_i2t_ln_then_t2i_split_route_at_full_width(dev, shared, B, T):
    """A box with two or more points gives T >= 9 tokens, 16 lanes a head: at
    C = 256 one block of the CUDA-core kernel holds neither the operands nor the
    128 x 256 context sums, so the pass runs as its I2T mode and then its T2I
    mode over two groups of 64 context columns; keys' and ctx at the kernel
    check's attention bar; three launches counted, the two T2I ones on the
    tensor cores."""
    from hybridgl_tpu_torch.kernels import decoder_pass

    S, tp = 4096, 16
    g = torch.Generator(device=dev).manual_seed(100 * B + T)

    def r(*shape, std=0.5, dtype=BF16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    f32, GT = torch.float32, TC_HEADS * tp
    Cq = TC_C // 2 if shared else TC_C
    assert decoder_pass.pass_route(BF16, S, Cq, TC_C, TC_HEADS, tp, GT, shared) == "split"
    off = r(B, TC_HEADS, tp, dtype=f32)
    off[:, :, T:] = -1e30
    ops = dict(w=r(B, Cq, GT, std=2 * Cq**-0.5, dtype=f32), off=off.reshape(B, GT), vo=r(B, GT, TC_C),
               const=r(TC_C, std=0.1, dtype=f32), ln_scale=1.0 + r(TC_C, std=0.1, dtype=f32),
               ln_bias=r(TC_C, std=0.1, dtype=f32))
    qside = r(1 if shared else B, S, Cq)
    base = r(1, S, TC_C) if shared else qside
    pe = r(1, S, TC_C)
    qw = r(B, TC_C, GT, std=2 * TC_C**-0.5, dtype=f32)
    qw.reshape(B, TC_C, TC_HEADS, tp)[..., T:] = 0.0
    before = (i2t_ln_then_t2i.launches, i2t_ln_then_t2i.tc_launches)
    keys, ctx = i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=TC_HEADS, tp=tp, shared_qside=shared)
    assert (i2t_ln_then_t2i.launches, i2t_ln_then_t2i.tc_launches) == (before[0] + 3, before[1] + 2)
    keys0, ctx0 = reference_i2t_ln_then_t2i(qside, base, pe, **ops, qw_next=qw, heads=TC_HEADS, tp=tp,
                                            shared_qside=shared)
    assert keys.shape == (B, S, TC_C) and ctx.shape == (B, GT, TC_C)
    close_tc(keys, keys0)
    close_tc(ctx, ctx0)
    live = (torch.arange(GT, device=dev) % tp) < T  # the padding lanes' columns are weightless, not compared
    close_tc(ctx[:, live], ctx0[:, live])


# ---------------------------------------------------------------------------
# The tensor-parallel encoder's shapes and the prepared decoder operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn,windows,heads,G", [
    (flash_windowed_fused, 25, 8, 14),  # ViT-H under mp = 2: 25 windows x 8 heads a rank
    (flash_windowed_fused, 25, 4, 14),  # mp = 4
    (flash_attention_fused, 1, 8, 64),  # the global blocks: 8 x [4096, 80]
    (flash_attention_fused, 1, 4, 64),
    (flash_windowed_fused, 9, 4, 5),    # short: S = 25, keys padded to 32
    (flash_windowed_fused, 3, 4, 13),   # ragged: S = 169, three key tiles, the last partial
    (flash_windowed_fused, 1, 1, 14),   # a single window-head
])
def test_rel_pos_attention_at_tensor_parallel_head_counts(dev, fn, windows, heads, G):
    """K1 and K2 at the heads a rank of the tensor-parallel encoder holds
    (head dim 80 unchanged): the tensor-core kernel takes every launch, the
    output meets the attention bar, and the rank's heads give the same bits
    as the same heads inside the full 16-head call."""
    hd, S = 80, G * G
    g = torch.Generator(device=dev).manual_seed(windows * heads + G)
    full = 16
    q, k, v = (torch.randn((windows, full, S, hd), generator=g, device=dev).bfloat16() for _ in range(3))
    rh, rw = (torch.randn((windows, full, S, G), generator=g, device=dev) * 0.5 for _ in range(2))

    def call(lo, hi):
        flat = lambda t: t[:, lo:hi].reshape(-1, *t.shape[2:]).contiguous()  # noqa: E731
        return fn(flat(q), flat(k), flat(v), flat(rh), flat(rw), G, hd**-0.5).reshape(windows, hi - lo, S, hd)

    before, before_tc = fn.launches, fn.tc_launches
    local = call(heads, 2 * heads)  # the second shard's head group
    assert (fn.launches, fn.tc_launches) == (before + 1, before_tc + 1)
    whole = call(0, full)
    torch.cuda.synchronize()
    assert torch.equal(local, whole[:, heads : 2 * heads])
    sl = lambda t: t[:, heads : 2 * heads].reshape(-1, *t.shape[2:]).float()  # noqa: E731
    want = reference_attention_rel_pos(sl(q), sl(k), sl(v), sl(rh), sl(rw), G, hd**-0.5).flatten()
    got = local.float().flatten()
    assert torch.isfinite(got).all()
    assert float(got @ want / (got.norm() * want.norm())) >= 0.999
    assert float((got - want).abs().mean() / want.abs().mean()) < 0.02


def _decoder_inputs(dev, dtype, B, seed):
    """SAM ViT-H decoder params (random, ``dtype``) with a [64, 64, 256] embedding and B point prompts."""
    from hybridgl_tpu_torch.core.config import sam_preset
    from hybridgl_tpu_torch.core.params import cast_tree, init_sam
    from hybridgl_tpu_torch.models.sam.prompt_encoder import dense_pe, embed_points, no_mask_dense

    cfg = sam_preset("vit_h")
    g = torch.Generator(device=dev).manual_seed(seed)
    p = cast_tree({k: v for k, v in init_sam(g, cfg).items() if k != "encoder"}, dtype)
    emb = (torch.randn((64, 64, 256), generator=g, device=dev) * 0.5).to(dtype)
    coords = torch.rand((B, 1, 2), generator=g, device=dev) * 1000
    sparse = embed_points(p["prompt"], coords, torch.ones((B, 1), device=dev), cfg, pad=True)
    return cfg, p, emb, dense_pe(p["prompt"], cfg), sparse, no_mask_dense(p["prompt"], cfg, 1)[0]


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("multimask", [True, False])
def test_k4_from_prepared_operands_gives_the_same_bits(dev, B, multimask):
    """K4 fed the prepared deconv matrices and f32 vectors (built once)
    against the same kernel fed the views it built on every call: only the
    place of the computation moved, so the masks are equal bit for bit."""
    from hybridgl_tpu_torch.models.sam.decoder import _prep_upscale

    cfg, p, emb, _, _, _ = _decoder_inputs(dev, torch.bfloat16, B, 3)
    g = torch.Generator(device=dev).manual_seed(B)
    u = p["decoder"]["upscale"]
    src = (torch.randn((B, 4096, 256), generator=g, device=dev) * 0.5).bfloat16()
    hyper = torch.randn((B, 3 if multimask else 1, 32), generator=g, device=dev).bfloat16()
    u1, u2, ln = u["deconv1"], u["deconv2"], u["ln"]
    w1 = u1["w"].permute(2, 0, 1, 3).reshape(256, 256).to(torch.bfloat16)
    w2 = u2["w"].permute(2, 0, 1, 3).reshape(64, 128).to(torch.bfloat16)
    before = upscale_hyper.tc_launches
    raw = upscale_hyper(src, w1, u1["b"], ln["scale"], ln["bias"], w2, u2["b"], hyper)
    pu = _prep_upscale(u, 256)
    prepared = upscale_hyper(src, pu["w1"], pu["b1"], pu["ln_s"], pu["ln_b"], pu["w2"], pu["b2"], hyper)
    torch.cuda.synchronize()
    assert upscale_hyper.tc_launches == before + 2
    assert torch.equal(raw, prepared) and torch.isfinite(raw).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 64])
def test_predict_masks_prepared_against_raw_on_the_card(dev, dtype, B):
    """The whole decoder at SAM's widths from the prepared tree against the
    raw tree, K3 fed from the prepared folds: on the decoder's bar in bf16
    (logits max|d| < 0.1, > 99.5% of thresholded pixels, IoU |d| < 2e-2; the
    folded products round once more) and to 2e-3 in f32; the same K3 and K4
    launches both ways, and K3's norm4 vectors and bias reach it in f32
    without a cast. At f32 the decoder runs at half width (the CUDA-core
    kernels' operands do not fit shared memory at C = 256)."""
    import dataclasses

    from hybridgl_tpu_torch.core.params import cast_tree, init_sam
    from hybridgl_tpu_torch.models.sam.decoder import predict_masks, prepare_decoder_params
    from hybridgl_tpu_torch.models.sam.prompt_encoder import dense_pe, embed_points, no_mask_dense

    if dtype == torch.bfloat16:
        cfg, p, emb, pe, sparse, dense = _decoder_inputs(dev, dtype, B, 5)
    else:
        from hybridgl_tpu_torch.core.config import sam_preset

        cfg = dataclasses.replace(sam_preset("vit_h"), prompt_dim=128, decoder_mlp_dim=1024)
        g = torch.Generator(device=dev).manual_seed(7)
        p = {k: v for k, v in init_sam(g, cfg).items() if k != "encoder"}
        emb = torch.randn((64, 64, 128), generator=g, device=dev) * 0.5
        coords = torch.rand((B, 1, 2), generator=g, device=dev) * 1000
        sparse = embed_points(p["prompt"], coords, torch.ones((B, 1), device=dev), cfg, pad=True)
        pe, dense = dense_pe(p["prompt"], cfg), no_mask_dense(p["prompt"], cfg, 1)[0]
    prep = prepare_decoder_params(p["decoder"], cfg)
    assert prep["transformer"]["layers"][1]["prepared_i2t"]["ln_scale"].dtype == torch.float32
    counts = []
    outs = []
    with torch.inference_mode():
        for tree in (p["decoder"], prep):
            before = (i2t_ln_then_t2i.launches, upscale_hyper.launches, i2t_ln_then_t2i.tc_launches)
            outs.append(predict_masks(tree, emb, pe, sparse, cfg, dense_prompts=dense))
            counts.append((i2t_ln_then_t2i.launches - before[0], upscale_hyper.launches - before[1],
                           i2t_ln_then_t2i.tc_launches - before[2]))
    torch.cuda.synchronize()
    (m_raw, iou_raw), (m_prep, iou_prep) = outs
    assert counts[0] == counts[1] == (2, 1, 2 if dtype == torch.bfloat16 else 0)
    assert torch.isfinite(m_prep).all()
    d = float((m_raw - m_prep).abs().max())
    if dtype == torch.bfloat16:
        assert d < 0.1 and float((iou_raw - iou_prep).abs().max()) < 2e-2
        assert float(((m_raw > 0) == (m_prep > 0)).float().mean()) > 0.995
    else:
        assert d < 2e-3 and float((iou_raw - iou_prep).abs().max()) < 2e-4


# ---- the kernels as registered operators (torch.ops.hybridgl.*) ----

OPERATORS = ("flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos", "clip_attention",
             "pass1_stats_half", "pass1_stats", "i2t_ln_then_t2i", "i2t_ln_update", "t2i_ctx", "upscale_hyper_blocked")


def _production_args(name, dev, seed=0):
    """The operator's arguments at the production shapes of tools/check_kernels.py, bf16 streams."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32

    def r(*shape, dtype=BF16, std=0.5):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    if name in ("flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos"):
        BH, G = (400, 14) if name == "flash_windowed_fused" else (16, 64)
        attn = (r(BH, G * G, 80), r(BH, G * G, 80), r(BH, G * G, 80), r(BH, G * G, G, dtype=f32),
                r(BH, G * G, G, dtype=f32), G)
        return attn if name == "flash_attention_rel_pos" else (*attn, 80**-0.5)
    if name == "clip_attention":
        bias = torch.where(torch.rand((128, 197), generator=g, device=dev) > 0.5, 0.0, torch.finfo(f32).min)
        bias[:, 0] = 0.0
        return r(1536, 197, 64), r(1536, 197, 64), r(1536, 197, 64), bias.contiguous(), 12, 0.125
    if name == "pass1_stats_half":
        Wy = _composed_axis_weights(640, 256, 1024, 768, 0, 480, dev).to(BF16)
        return r(192, 256, 640, std=2.0), Wy, [0.0, 0.0, 480.0, 640.0], 0.0, 1.0
    if name == "pass1_stats":
        Wy = _composed_axis_weights(640, 256, 1024, 768, 0, 480, dev).to(BF16)
        WxT = _composed_axis_weights(640, 256, 1024, 1024, 0, 640, dev).T.contiguous().to(BF16)
        return r(192, 256, 256, std=4.0), WxT, Wy, [0.0, 0.0, 480.0, 640.0], 0.0, 1.0
    off = r(128, 8, 8, dtype=f32)
    off[:, :, 7:] = -1e30
    B = 64 if name == "i2t_ln_then_t2i" else 128
    ops = (r(B, 256, 64, dtype=f32, std=0.125), off[:B].reshape(B, 64), r(B, 64, 256), r(256, dtype=f32, std=0.1),
           1.0 + r(256, dtype=f32, std=0.1), r(256, dtype=f32, std=0.1))
    keys, pe, qw = r(B, 4096, 256), r(1, 4096, 256), r(B, 256, 64, dtype=f32, std=0.125)
    if name == "i2t_ln_then_t2i":
        return (keys, keys, pe, *ops, qw, 8, 8, False)
    if name == "i2t_ln_update":
        return (keys, keys, *ops, 8, 8, pe)
    if name == "t2i_ctx":
        return keys, pe, qw
    return (r(64, 4096, 256), r(256, 256, std=0.0625), r(64, dtype=f32, std=0.1), 1.0 + r(64, dtype=f32, std=0.1),
            r(64, dtype=f32, std=0.1), r(64, 128, std=0.125), r(32, dtype=f32, std=0.1), r(64, 3, 32))


@pytest.mark.parametrize("name", OPERATORS)
def test_operator_equals_the_direct_launch(dev, name):
    """torch.ops.hybridgl.<name> on CUDA tensors is the ctypes launch it
    dispatches to, bit for bit, at production shapes, and counts one call
    of it on the wrapper (every launch on the tensor-core kernel)."""
    from hybridgl_tpu_torch.kernels import _ops, kernel_wrappers

    args = _production_args(dev=dev, name=name)
    wrapper = kernel_wrappers()[name]
    before = (wrapper.launches, wrapper.tc_launches)
    got = getattr(torch.ops.hybridgl, name).default(*args)
    counted = (wrapper.launches - before[0], wrapper.tc_launches - before[1])
    want = _ops.REGISTERED[name].cuda(*args)
    torch.cuda.synchronize()
    got, want = (list(x) if isinstance(x, tuple) else [x] for x in (got, want))
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(a.is_cuda for a in got) and counted == (1, 1)


@pytest.mark.parametrize("name", ["flash_windowed_fused", "flash_attention_fused", "clip_attention"])
def test_opcheck_on_the_card(dev, name):
    """opcheck on CUDA tensors for K1, K2 and K6: schema, fake tensors,
    autograd registration, and AOTAutograd with symbolic shapes."""
    utils = ("test_schema", "test_faketensor", "test_autograd_registration", "test_aot_dispatch_dynamic")
    if name == "flash_windowed_fused":  # a production share of the windows: opcheck runs the operator often
        g = torch.Generator(device=dev).manual_seed(1)
        args = tuple(torch.randn((32, 196, 80), generator=g, device=dev).to(BF16) for _ in range(3)) + tuple(
            torch.randn((32, 196, 14), generator=g, device=dev) * 0.5 for _ in range(2)) + (14, 80**-0.5)
    else:
        args = _production_args(name, dev)
    result = torch.library.opcheck(getattr(torch.ops.hybridgl, name).default, args, test_utils=utils)
    assert result == dict.fromkeys(utils, "SUCCESS")


def test_exported_encoder_on_the_card_equals_eager(dev, tmp_path):
    """A two-block bf16 encoder at ViT-H's attention geometry (hd 80, windows
    of 14 on a 64-grid: K1 on the resident tensor-core kernel, K2 on the
    stream kernel) exported on the card, saved and reloaded: equal to the
    eager port on the card, and every launch of its run on the tensor cores."""
    from hybridgl_tpu_torch.core.config import PipelineConfig, SamConfig, clip_preset
    from hybridgl_tpu_torch.core.params import cast_tree, init_sam
    from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts, tc_launch_counts
    from hybridgl_tpu_torch.models.sam.image_encoder import encode_image, prepare_sam_params
    from hybridgl_tpu_torch.tools import export_serving

    sam = SamConfig(img_size=1024, encoder_width=160, encoder_depth=2, encoder_heads=2, encoder_global_idx=(1,),
                    window_size=14, prompt_dim=32)
    cfg = PipelineConfig(sam_config=sam, clip_config=clip_preset("test-tiny"))
    g = torch.Generator(device=dev).manual_seed(2)
    enc = prepare_sam_params({"encoder": cast_tree(init_sam(g, sam), BF16)["encoder"]}, sam)["encoder"]
    for blk in enc["blocks"]:
        for key in ("rel_tab_h", "rel_tab_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g, device=dev) * 0.2
    image = torch.randn((1, 1024, 1024, 3), generator=g, device=dev)
    program = export_serving.export_encoder(cfg, enc, dev)
    assert export_serving.kernel_nodes(program) == {"flash_windowed_fused": 1, "flash_attention_fused": 1}
    path = tmp_path / "sam_encoder.pt2"
    torch.export.save(program, path)
    loaded = export_serving.load_exported(path).module()
    with torch.no_grad():
        want = encode_image(enc, image, sam)
        reset_launch_counts()
        got = loaded(enc, image)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {k: v for k, v in tc_launch_counts().items() if v} == {
        "flash_windowed_fused": 1, "flash_attention_fused": 1}
    assert torch.equal(got, want) and torch.isfinite(got.float()).all()
