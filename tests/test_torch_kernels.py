"""The port's kernel functions (their plain PyTorch versions, which the
wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, plus the plain tensor primitives around them.

Inputs come from a numpy seed and go to both packages; everything is f32.
Tolerance: max|d| <= 1e-4 unless a test states otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridgl_tpu.kernels import blur as jblur
from hybridgl_tpu.kernels import clip_attention as jclip
from hybridgl_tpu.kernels import flash_attention as jflash
from hybridgl_tpu.kernels import masks as jmasks
from hybridgl_tpu.kernels import nms as jnms
from hybridgl_tpu.kernels import pass1_stats as jstats
from hybridgl_tpu.kernels import resize as jresize
from hybridgl_tpu_torch.kernels import blur, masks, nms, resize
from hybridgl_tpu_torch.kernels.clip_attention import clip_attention
from hybridgl_tpu_torch.kernels.flash_attention import flash_attention_fused, flash_windowed_fused
from hybridgl_tpu_torch.kernels.pass1_stats import pass1_stats, pass1_stats_half

TOL = 1e-4


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_k1_flash_windowed_fused_matches_jax():
    rng = np.random.default_rng(11)
    B, G, H, hd = 3, 8, 2, 16
    S, D = G * G, H * hd
    qkv = rng.standard_normal((B, S, 3 * D)).astype(np.float32)
    rel_h = (rng.standard_normal((B, S, H * G)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((B, S, H * G)) * 0.5).astype(np.float32)
    want = np.asarray(
        jflash.flash_windowed_fused(jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w), H, G)
    )
    lane = want.shape[-1] // H
    want = want.reshape(B, S, H, lane)[..., :hd]  # first hd lanes of each head

    def heads(x, width):  # [B, S, H*width] -> [B*H, S, width]
        return t(x.reshape(B, S, H, width).transpose(0, 2, 1, 3).reshape(B * H, S, width))

    q, k, v = (heads(qkv[..., i * D : (i + 1) * D], hd) for i in range(3))
    got = flash_windowed_fused(q, k, v, heads(rel_h, G), heads(rel_w, G), G, hd**-0.5)
    got = got.reshape(B, H, S, hd).permute(0, 2, 1, 3).numpy()
    assert maxdiff(got, want) <= TOL


def test_k2_flash_attention_fused_matches_jax():
    rng = np.random.default_rng(12)
    BH, G, hd = 4, 8, 16
    S = G * G
    q, k, v = (rng.standard_normal((BH, S, hd)).astype(np.float32) for _ in range(3))
    rel_h = (rng.standard_normal((BH, S, G)) * 0.5).astype(np.float32)
    rel_w = (rng.standard_normal((BH, S, G)) * 0.5).astype(np.float32)
    scale = hd**-0.5
    want = jflash.flash_attention_fused(
        jnp.asarray(q * scale), jnp.asarray(k), jnp.asarray(v), jnp.asarray(rel_h),
        jnp.asarray(rel_w), G, block_q=32, block_k=32,
    )
    got = flash_attention_fused(t(q), t(k), t(v), t(rel_h), t(rel_w), G, scale)
    assert maxdiff(got.numpy(), want) <= TOL


@pytest.mark.parametrize("with_bias", [True, False])
def test_k6_clip_attention_matches_jax(with_bias):
    rng = np.random.default_rng(13)
    N, H, L, hd = 3, 2, 17, 16
    q, k, v = (rng.standard_normal((N, H, L, hd)).astype(np.float32) for _ in range(3))
    scale = hd**-0.5
    allowed = rng.random((N, L)) > 0.5
    allowed[:, 0] = True
    cls_bias = np.where(allowed, 0.0, np.finfo(np.float32).min).astype(np.float32)
    # the JAX kernel reads head-major q|k|v groups with q pre-scaled
    qkv = np.stack([q * scale, k, v], axis=2).transpose(0, 3, 1, 2, 4).reshape(N, L, H * 3 * hd)
    bias = cls_bias if with_bias else None
    want = np.asarray(jclip.clip_attention(jnp.asarray(qkv), None if bias is None else jnp.asarray(bias), H))
    want = want.reshape(N, L, H, hd)
    got = clip_attention(
        t(q.reshape(N * H, L, hd)), t(k.reshape(N * H, L, hd)), t(v.reshape(N * H, L, hd)),
        None if bias is None else t(bias), H, scale,
    )
    got = got.reshape(N, H, L, hd).permute(0, 2, 1, 3).numpy()
    assert np.isfinite(got).all()
    assert maxdiff(got, want) <= TOL


WINDOWS = [(0.0, 0.0, 48, 40), (7.0, 3.0, 30, 55), (3.0, 5.0, 50, 40)]


@pytest.mark.parametrize("window", WINDOWS)
def test_k5_pass1_stats_half_f32_matches_jax(monkeypatch, window):
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", "0")
    rng = np.random.default_rng(14)
    B, n, C, mid = 6, 16, 64, 128
    y0, x0, dh, dw = window
    tmp = (rng.standard_normal((B, n, C)) * 2.0).astype(np.float32)
    Wy = np.asarray(jresize._composed_axis_weights(C, n, mid, int(mid * 0.9), y0, dh))
    s0, r0, c0 = (np.asarray(a) for a in jstats.pass1_stats_half(jnp.asarray(tmp), jnp.asarray(Wy), window, 0.0, 1.0))
    s1, r1, c1 = pass1_stats_half(t(tmp), t(Wy), window, 0.0, 1.0)
    np.testing.assert_allclose(s1.numpy(), s0, atol=1e-5)
    np.testing.assert_array_equal(r1.numpy(), r0)
    np.testing.assert_array_equal(c1.numpy(), c0)


@pytest.mark.parametrize("window", WINDOWS)
def test_k5_pass1_stats_half_bf16_close_to_jax(monkeypatch, window):
    """Default bf16 operands on both sides; the bar of
    tests/test_pass1_stats.py:test_bf16_stats_close (stability within 2e-2,
    profile flips under 3%)."""
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", "1")
    rng = np.random.default_rng(15)
    B, n, C, mid = 8, 16, 64, 128
    y0, x0, dh, dw = window
    tmp = (rng.standard_normal((B, n, C)) * 2.0).astype(np.float32)
    Wy = np.asarray(jresize._composed_axis_weights(C, n, mid, int(mid * 0.9), y0, dh))
    s0, r0, c0 = (np.asarray(a) for a in jstats.pass1_stats_half(jnp.asarray(tmp), jnp.asarray(Wy), window, 0.0, 1.0))
    s1, r1, c1 = (a.numpy() for a in pass1_stats_half(t(tmp), t(Wy), window, 0.0, 1.0))
    assert np.abs(s1 - s0).max() < 2e-2
    assert (r1 != r0).mean() < 0.03
    assert (c1 != c0).mean() < 0.03


# the short and ragged shapes the card tests hold the CUDA kernels to
# (tests/test_torch_cuda_kernels.py): there the plain versions are the
# yardstick, so here they are themselves held to the JAX kernels at those shapes
RAGGED_K5 = [
    # B, n, C, window (y0, x0, dh, dw)
    (5, 64, 200, (0.0, 0.0, 128, 128)),      # the window ends on a 64-row tile edge and a 128-column strip edge
    (5, 16, 136, (3.0, 5.0, 61, 40)),        # narrower than one strip, inside one row tile
    (4, 48, 320, (63.0, 127.0, 2, 2)),       # a 2 x 2 window across a tile corner
    (4, 112, 264, (130.0, 250.0, 134, 14)),  # 8 live columns in the last strip, a ragged last row tile
    (1, 32, 72, (10.0, 0.0, 50, 72)),        # B = 1, C smaller than one strip
]


@pytest.mark.parametrize("bf16", ["0", "1"])
@pytest.mark.parametrize("B,n,C,window", RAGGED_K5)
def test_k5_pass1_stats_half_ragged_windows_match_jax(monkeypatch, bf16, B, n, C, window):
    """f32: stability within 1e-5 and equal flags; bf16 operands on both
    sides: the bar of test_k5_pass1_stats_half_bf16_close_to_jax. No flag
    outside the window in either."""
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", bf16)
    rng = np.random.default_rng(n + C)
    y0, x0, dh, dw = window
    tmp = (rng.standard_normal((B, n, C)) * 2.0).astype(np.float32)
    Wy = np.asarray(jresize._composed_axis_weights(C, n, 2 * C, 2 * C - 26, y0, dh))
    s0, r0, c0 = (np.asarray(a) for a in jstats.pass1_stats_half(jnp.asarray(tmp), jnp.asarray(Wy), window, 0.0, 1.0))
    s1, r1, c1 = (a.numpy() for a in pass1_stats_half(t(tmp), t(Wy), window, 0.0, 1.0))
    assert r0.any() and c0.any()
    if bf16 == "0":
        np.testing.assert_allclose(s1, s0, atol=1e-5)
        np.testing.assert_array_equal(r1, r0)
        np.testing.assert_array_equal(c1, c0)
    else:
        assert np.abs(s1 - s0).max() < 2e-2
        assert (r1 != r0).mean() < 0.03
        assert (c1 != c0).mean() < 0.03
    idx = np.arange(C)
    assert not r1[:, (idx < y0) | (idx >= y0 + dh)].any()
    assert not c1[:, (idx < x0) | (idx >= x0 + dw)].any()


# K10 at the shapes of its card tests: the plain version (half_transform, then
# the plain stats) is the card's yardstick, so here it is held to the JAX
# kernel's full mode in interpret mode
RAGGED_K10 = [
    # B, n, n2, C, window (y0, x0, dh, dw)
    (5, 16, 16, 136, (3.0, 5.0, 61, 40)),
    (5, 48, 32, 320, (63.0, 127.0, 20, 30)),
    (4, 240, 256, 264, (130.0, 100.0, 134, 140)),
    (4, 64, 256, 200, (0.0, 0.0, 128, 128)),
    (3, 192, 16, 72, (10.0, 0.0, 50, 72)),
]


@pytest.mark.parametrize("bf16", ["0", "1"])
@pytest.mark.parametrize("B,n,n2,C,window", RAGGED_K10)
def test_k10_pass1_stats_ragged_shapes_match_jax(monkeypatch, bf16, B, n, n2, C, window):
    """Smooth decoder-like logits through both packages. f32 stats: equal
    boxes, stability |d| <= 1e-4. bf16 stats (operands and tmp rounded on
    both sides): stability |d| <= 1e-3, box edges within 1 px. No flag outside
    the window in either."""
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", bf16)
    rng = np.random.default_rng(n + n2 + C)
    y0, x0, dh, dw = window
    coarse = torch.from_numpy(rng.standard_normal((B, 1, 5, 5)).astype(np.float32) * 6.0)
    low = torch.nn.functional.interpolate(coarse, size=(n, n2), mode="bilinear")[:, 0].numpy()
    low = low + rng.standard_normal((B, n, n2)).astype(np.float32) * 0.1
    Wy = np.asarray(jresize._composed_axis_weights(C, n, 2 * C, 2 * C - 26, y0, dh))
    WxT = np.ascontiguousarray(np.asarray(jresize._composed_axis_weights(C, n2, 2 * C, 2 * C - 10, x0, dw)).T)
    s0, r0, c0 = (np.asarray(a) for a in jstats.pass1_stats(
        jnp.asarray(low), jnp.asarray(WxT), jnp.asarray(Wy), window, 0.0, 1.0))
    s1, r1, c1 = (a.numpy() for a in pass1_stats(t(low), t(WxT), t(Wy), window, 0.0, 1.0))
    assert r0.any() and c0.any()
    edges = np.abs(masks.box_from_profiles(t(r1), t(c1)).numpy()
                   - masks.box_from_profiles(t(np.array(r0 > 0)), t(np.array(c0 > 0))).numpy()).max()
    assert np.abs(s1 - s0).max() <= (1e-4 if bf16 == "0" else 1e-3)
    assert edges <= (0.0 if bf16 == "0" else 1.0)
    idx = np.arange(C)
    assert not r1[:, (idx < y0) | (idx >= y0 + dh)].any()
    assert not c1[:, (idx < x0) | (idx >= x0 + dw)].any()


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("L,hd", [(50, 64), (197, 64), (65, 16)])
def test_k6_clip_attention_lengths_match_jax(L, hd, with_bias):
    """ViT-B/32's L = 50 and ViT-B/16's L = 197 at hd = 64, and one key past a
    64-key tile; query row 0, the only biased row, also on its own."""
    rng = np.random.default_rng(L + hd)
    N, H = 2, 2
    q, k, v = (rng.standard_normal((N, H, L, hd)).astype(np.float32) for _ in range(3))
    scale = hd**-0.5
    allowed = rng.random((N, L)) > 0.5
    allowed[:, 0] = True
    allowed[1, 1:] = False  # a proposal whose CLS row sees only itself
    bias = np.where(allowed, 0.0, np.finfo(np.float32).min).astype(np.float32) if with_bias else None
    qkv = np.stack([q * scale, k, v], axis=2).transpose(0, 3, 1, 2, 4).reshape(N, L, H * 3 * hd)
    want = np.asarray(jclip.clip_attention(jnp.asarray(qkv), None if bias is None else jnp.asarray(bias), H))
    want = want.reshape(N, L, H, hd)
    got = clip_attention(
        t(q.reshape(N * H, L, hd)), t(k.reshape(N * H, L, hd)), t(v.reshape(N * H, L, hd)),
        None if bias is None else t(bias), H, scale,
    )
    got = got.reshape(N, H, L, hd).permute(0, 2, 1, 3).numpy()
    assert np.isfinite(got).all()
    assert maxdiff(got, want) <= TOL
    assert maxdiff(got[:, 0], want[:, 0]) <= TOL
    if with_bias:
        assert maxdiff(got[1, 0], v[1, :, 0]) <= TOL  # the masked stream's CLS row returns v[0]


# --------------------------------------------------------------------------
# plain primitives around the kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "args",
    [(640, 256, 1024, 768, 0, 480), (64, 16, 128, 115, 7, 30), (96, 64, 64, 57, 3, 50)],
)
def test_composed_axis_weights_match_jax(args):
    want = np.asarray(jresize._composed_axis_weights(*args))
    got = resize._composed_axis_weights(*args).numpy()
    assert maxdiff(got, want) <= 1e-6


def test_place_two_stage_matches_jax():
    rng = np.random.default_rng(16)
    low = rng.standard_normal((3, 16, 16)).astype(np.float32)
    args = (128, (115, 89), (64, 64), (0, 0), (48, 40))
    want = jresize.place_two_stage(jnp.asarray(low), *args, fill=-1e4)
    got = resize.place_two_stage(t(low), *args, fill=-1e4)
    assert maxdiff(got.numpy(), want) <= TOL


@pytest.mark.parametrize("src_hw", [None, (20, 27)])
def test_resize_bilinear_matches_jax(src_hw):
    rng = np.random.default_rng(17)
    img = rng.standard_normal((32, 32, 3)).astype(np.float32)
    want = jresize.resize_bilinear(jnp.asarray(img), (24, 40), src_hw=src_hw)
    got = resize.resize_bilinear(t(img), (24, 40), src_hw=src_hw)
    assert maxdiff(got.numpy(), want) <= TOL


@pytest.mark.parametrize("dst_hw", [(60, 50), (20, 13)])
def test_place_valid_region_antialias_matches_jax(dst_hw):
    rng = np.random.default_rng(18)
    img = rng.standard_normal((32, 32)).astype(np.float32)
    want = jresize.place_valid_region_antialias(jnp.asarray(img), (64, 64), dst_hw)
    got = resize.place_valid_region_antialias(t(img), (64, 64), dst_hw)
    assert maxdiff(got.numpy(), want) <= TOL


def test_gaussian_blur_matches_jax():
    rng = np.random.default_rng(19)
    img = (rng.random((40, 36, 3)) * 255).astype(np.float32)
    want = jblur.gaussian_blur(jnp.asarray(img), 15)
    got = blur.gaussian_blur(t(img), 15)
    assert maxdiff(got.numpy(), want) <= 1e-3  # values up to 255


def test_nms_and_boxes_match_jax():
    rng = np.random.default_rng(20)
    N = 40
    xy = rng.random((N, 2)) * 50
    wh = rng.random((N, 2)) * 30 + 1
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[5] = boxes[4]  # an exact duplicate
    scores = rng.random(N).astype(np.float32)
    valid = rng.random(N) > 0.2
    jr = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, jnp.asarray(valid))
    tr = nms.nms(t(boxes), t(scores), 0.5, t(valid))
    np.testing.assert_array_equal(tr.order.numpy(), np.asarray(jr.order))
    np.testing.assert_array_equal(tr.keep_sorted.numpy(), np.asarray(jr.keep_sorted))
    jk, jv = jnms.kept_in_score_order(jr, 16)
    tk, tv = nms.kept_in_score_order(tr, 16)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    m = rng.random((4, 20, 24)) > 0.7
    m[2] = False
    np.testing.assert_array_equal(masks.mask_to_box(t(m)).numpy(), np.asarray(jmasks.mask_to_box(jnp.asarray(m))))


# --------------------------------------------------------------------------
# which CUDA kernel a call takes (plain Python, mirrored by the C dispatch)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,n,C,kind", [
    (torch.bfloat16, 256, 640, "wgmma"), (torch.bfloat16, 256, 1024, "wgmma"), (torch.bfloat16, 16, 72, "wgmma"),
    (torch.float32, 256, 640, "cuda-core"),  # f32 stats are held to equal boxes: the f32 kernel stays
    (torch.bfloat16, 200, 640, "cuda-core"),  # no whole number of 16-deep product steps
    (torch.bfloat16, 272, 640, "cuda-core"),  # the strip and the Wy tiles would not fit in shared memory
    (torch.bfloat16, 256, 100, "cuda-core"),  # rows of C elements are no whole 16-byte chunks
])
def test_k5_variant(dtype, n, C, kind):
    from hybridgl_tpu_torch.kernels import pass1_stats as mod

    assert mod.variant(dtype, n, C) == kind


@pytest.mark.parametrize("dtype,n,n2,C,kind", [
    (torch.bfloat16, 256, 256, 640, "wgmma"), (torch.bfloat16, 256, 256, 1024, "wgmma"),
    (torch.bfloat16, 16, 16, 8, "wgmma"), (torch.bfloat16, 64, 256, 200, "wgmma"), (torch.bfloat16, 240, 48, 72, "wgmma"),
    (torch.float32, 256, 256, 640, "cuda-core"),  # f32 stats are held to equal boxes: the f32 kernel stays
    (torch.bfloat16, 200, 256, 640, "cuda-core"),  # K5's limits on n and C hold for the sweep
    (torch.bfloat16, 256, 256, 100, "cuda-core"),
    (torch.bfloat16, 256, 200, 640, "cuda-core"),  # the column transform's contraction: whole 16-deep steps
    (torch.bfloat16, 256, 8, 640, "cuda-core"),
    (torch.bfloat16, 64, 272, 640, "cuda-core"),  # the staged WxT strip and low tiles would not fit
])
def test_k10_variant(dtype, n, n2, C, kind):
    from hybridgl_tpu_torch.kernels import pass1_stats as mod

    assert mod.variant_full(dtype, n, n2, C) == kind


@pytest.mark.parametrize("dtype,L,hd,kind", [
    (torch.bfloat16, 197, 64, "wgmma"), (torch.bfloat16, 50, 64, "wgmma"), (torch.bfloat16, 256, 80, "wgmma"),
    (torch.float32, 197, 64, "cuda-core"), (torch.bfloat16, 197, 32, "cuda-core"),
    (torch.bfloat16, 257, 64, "wgmma"),  # ViT-L/14: four warpgroups walk a head past 256 keys
    (torch.bfloat16, 577, 64, "wgmma"), (torch.bfloat16, 577, 80, "wgmma"),  # ViT-L/14@336's G2L blocks
    (torch.float32, 577, 64, "cuda-core"),  # f32 launches the CUDA-core kernel, exact in f32
    (torch.bfloat16, 578, 64, "plain"),
    (torch.bfloat16, 785, 64, "plain"), (torch.bfloat16, 1025, 64, "plain"),  # GEM: ViT-B/16, ViT-L/14@336
    (torch.float32, 785, 64, "plain"),
])
def test_k6_variant(dtype, L, hd, kind):
    from hybridgl_tpu_torch.kernels import clip_attention as mod

    assert mod.variant(dtype, L, hd) == kind


def test_tensor_core_launch_counts_reset_with_the_others():
    from hybridgl_tpu_torch.kernels import (
        GLUE,
        SAM_GLUE,
        kernel_wrappers,
        launch_counts,
        reset_launch_counts,
        tc_launch_counts,
    )

    wrappers = kernel_wrappers()
    # every wrapper of a TPU kernel, and GEM's attention, has a tensor-core kernel behind it (K1, K2
    # and K9 count theirs since the tensor-parallel encoder checks that its head shards still take it);
    # the port's own NMS kernel and the CLIP and SAM blocks' fused glue run on the CUDA cores and count
    # their launches only
    assert set(tc_launch_counts()) == set(wrappers) - {"nms", *GLUE, *SAM_GLUE} and len(wrappers) == 25
    assert launch_counts()["nms"] == 0
    wrappers["pass1_stats_half"].launches = wrappers["pass1_stats_half"].tc_launches = 3
    wrappers["layer_norm"].launches = 2
    reset_launch_counts()
    assert not any(launch_counts().values()) and not any(tc_launch_counts().values())
    # a CPU call runs the plain version and counts nothing
    x = torch.zeros((2, 5, 16))
    clip_attention(x, x, x, None, 2, 0.25)
    assert not any(launch_counts().values()) and not any(tc_launch_counts().values())


def test_k5_zeroed_outputs_are_views_of_one_buffer():
    from hybridgl_tpu_torch.kernels.pass1_stats import _zeroed_outputs

    counts, flags = _zeroed_outputs(3, 24, "cpu")
    rows, cols = flags
    assert (counts.shape, counts.dtype) == ((3, 2), torch.int32)
    assert rows.shape == cols.shape == (3, 24) and rows.dtype == cols.dtype == torch.bool
    assert not counts.any() and not rows.any() and not cols.any()
    assert rows.is_contiguous() and cols.is_contiguous() and counts.is_contiguous()
    base = counts.untyped_storage().data_ptr()
    assert rows.untyped_storage().data_ptr() == base and cols.untyped_storage().data_ptr() == base
