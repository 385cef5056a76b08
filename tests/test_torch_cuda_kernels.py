"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (partial tiles, every supported head dim, K9's
TPU tiles, K10's ragged n, n2 and C; for the
decoder kernels S = 300, tp in {8, 16}, heads in {2, 8}, Cq != C, B = 3), in
f32 and bf16. Marked ``cuda``; each test skips where no CUDA card is present.
Run on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerances: f32 max|d| <= 1e-4 (f32 math on both sides, summed in another
order); bf16 outputs cos >= 0.999 (one bf16 rounding of the output).
"""

import pytest
import torch

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
