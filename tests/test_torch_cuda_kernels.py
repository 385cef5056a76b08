"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (partial tiles, every supported head dim), in f32
and bf16. Marked ``cuda``; each test skips where no CUDA card is present.
Run on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerances: f32 max|d| <= 1e-4 (f32 math on both sides, summed in another
order); bf16 outputs cos >= 0.999 (one bf16 rounding of the output).
"""

import pytest
import torch

from hybridgl_tpu_torch.kernels.clip_attention import clip_attention, reference_clip_attention
from hybridgl_tpu_torch.kernels.flash_attention import (
    flash_attention_fused,
    flash_windowed_fused,
    reference_attention_rel_pos,
)
from hybridgl_tpu_torch.kernels.pass1_stats import pass1_stats_half, reference_pass1_stats_half
from hybridgl_tpu_torch.kernels.resize import _composed_axis_weights

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
