"""The port's K9 (flash_attention_rel_pos) and K10 (pass1_stats, full mode)
against the JAX package's Pallas kernels in interpret mode, on CPU, at the
cases of tests/test_flash_attention.py and tests/test_pass1_stats.py.
Inputs come from a numpy seed and go to both packages.

Tolerances: K9 2e-5 (1e-4 for the extreme logits), as the reference's
tests; K10 with HYBRIDGL_STATS_BF16=0 stability atol 1e-5 and equal
profiles, with the bf16 default stability within 2e-2 and profile flips
under 3% (the bars of test_bf16_stats_close).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridgl_tpu.kernels import flash_attention as jflash
from hybridgl_tpu.kernels import pass1_stats as jstats
from hybridgl_tpu.kernels.resize import _composed_axis_weights
from hybridgl_tpu_torch.kernels.flash_attention import flash_attention_rel_pos
from hybridgl_tpu_torch.kernels.pass1_stats import pass1_stats


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def rel_pos_inputs(seed, BH, G, hd, qk_std=0.3, rel_std=0.5):
    rng = np.random.default_rng(seed)
    S = G * G
    q = (rng.standard_normal((BH, S, hd)) * qk_std).astype(np.float32)
    k = (rng.standard_normal((BH, S, hd)) * qk_std).astype(np.float32)
    v = rng.standard_normal((BH, S, hd)).astype(np.float32)
    rel_h = (rng.standard_normal((BH, S, G)) * rel_std).astype(np.float32)
    rel_w = (rng.standard_normal((BH, S, G)) * rel_std).astype(np.float32)
    return q, k, v, rel_h, rel_w


@pytest.mark.parametrize(
    "BH,G,hd,block_q,block_k,tol",
    [
        (3, 8, 16, 32, 32, 2e-5),
        (3, 8, 16, 64, 16, 2e-5),
        (3, 8, 16, 16, 64, 2e-5),
        (4, 14, 80, 196, 196, 2e-5),  # the windowed geometry: one window per program
    ],
)
def test_k9_flash_attention_rel_pos_matches_jax(BH, G, hd, block_q, block_k, tol):
    q, k, v, rel_h, rel_w = rel_pos_inputs(G * hd + block_q, BH, G, hd)
    want = np.asarray(
        jflash.flash_attention_rel_pos(
            *(jnp.asarray(a) for a in (q, k, v, rel_h, rel_w)), G, block_q=block_q, block_k=block_k, interpret=True
        )
    )
    got = flash_attention_rel_pos(t(q), t(k), t(v), t(rel_h), t(rel_w), G, block_q=block_q, block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_k9_extreme_logits_hd8():
    """Online softmax over large score magnitudes stays finite (hd 8, zero rel terms)."""
    q, k, v, _, _ = rel_pos_inputs(5, 1, 8, 8, qk_std=30.0)
    zeros = np.zeros((1, 64, 8), np.float32)
    want = np.asarray(
        jflash.flash_attention_rel_pos(
            *(jnp.asarray(a) for a in (q, k, v, zeros, zeros)), 8, block_q=16, block_k=16, interpret=True
        )
    )
    got = flash_attention_rel_pos(t(q), t(k), t(v), t(zeros), t(zeros), 8, block_q=16, block_k=16).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_k9_rel_terms_widen_and_blocks_checked():
    """bf16 rel terms are widened to f32 (the reference widens inside its
    kernel); the TPU tiles are checked as the reference asserts them."""
    q, k, v, rel_h, rel_w = rel_pos_inputs(6, 2, 8, 16)
    rh16, rw16 = t(rel_h).bfloat16(), t(rel_w).bfloat16()
    got = flash_attention_rel_pos(t(q), t(k), t(v), rh16, rw16, 8, block_q=32, block_k=32)
    want = flash_attention_rel_pos(t(q), t(k), t(v), rh16.float(), rw16.float(), 8, block_q=32, block_k=32)
    assert torch.equal(got, want)
    for bad in (dict(block_q=48, block_k=32), dict(block_q=32, block_k=12), dict(block_q=32, block_k=20)):
        with pytest.raises(ValueError):
            flash_attention_rel_pos(t(q), t(k), t(v), t(rel_h), t(rel_w), 8, **bad)
    with pytest.raises(ValueError, match="grid_side"):
        flash_attention_rel_pos(t(q), t(k), t(v), t(rel_h), t(rel_w), 7, block_q=7, block_k=7)


K10_CASES = [
    (64, 128, (0.0, 0.0, 48, 40)),
    (64, 128, (7.0, 3.0, 30, 55)),
    (96, 64, (0.0, 0.0, 96, 96)),
]


def k10_inputs(C, mid, window, seed, B=5, n=16):
    rng = np.random.default_rng(seed)
    y0, x0, dh, dw = window
    low = (rng.standard_normal((B, n, n)) * 2.0).astype(np.float32)
    Wy = np.asarray(_composed_axis_weights(C, n, mid, int(mid * 0.9), y0, dh))
    Wx = np.asarray(_composed_axis_weights(C, n, mid, int(mid * 0.7), x0, dw))
    return low, np.ascontiguousarray(Wx.T), Wy


@pytest.mark.parametrize("C,mid,window", K10_CASES)
def test_k10_pass1_stats_f32_matches_jax(monkeypatch, C, mid, window):
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", "0")
    low, WxT, Wy = k10_inputs(C, mid, window, seed=C + mid)
    s0, r0, c0 = (np.asarray(a) for a in jstats.pass1_stats(
        jnp.asarray(low), jnp.asarray(WxT), jnp.asarray(Wy), window, 0.0, 1.0))
    s1, r1, c1 = (a.numpy() for a in pass1_stats(t(low), t(WxT), t(Wy), window, 0.0, 1.0))
    np.testing.assert_allclose(s1, s0, atol=1e-5)
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(c1, c0)
    assert r0.any()


@pytest.mark.parametrize("C,mid,window", K10_CASES)
def test_k10_pass1_stats_bf16_close_to_jax(monkeypatch, C, mid, window):
    monkeypatch.setenv("HYBRIDGL_STATS_BF16", "1")
    low, WxT, Wy = k10_inputs(C, mid, window, seed=C + mid + 1, B=8)
    s0, r0, c0 = (np.asarray(a) for a in jstats.pass1_stats(
        jnp.asarray(low), jnp.asarray(WxT), jnp.asarray(Wy), window, 0.0, 1.0))
    s1, r1, c1 = (a.numpy() for a in pass1_stats(t(low), t(WxT), t(Wy), window, 0.0, 1.0))
    assert np.abs(s1 - s0).max() < 2e-2
    assert (r1 != r0).mean() < 0.03
    assert (c1 != c0).mean() < 0.03


def test_k10_zero_lo_gives_zero_stability():
    """A candidate empty even at thresh - offset: stability 0 (the chain's
    0/0 would be nan; equivalent, since the nonempty test fails too)."""
    n, B, C, mid = 16, 2, 64, 128
    low = np.full((B, n, n), -100.0, np.float32)
    Wy = np.asarray(_composed_axis_weights(C, n, mid, mid, 0, 50))
    WxT = np.ascontiguousarray(np.asarray(_composed_axis_weights(C, n, mid, mid, 0, 50)).T)
    s0, r0, _ = jstats.pass1_stats(jnp.asarray(low), jnp.asarray(WxT), jnp.asarray(Wy), (0, 0, 50, 50), 0.0, 1.0)
    s1, r1, _ = pass1_stats(t(low), t(WxT), t(Wy), (0, 0, 50, 50), 0.0, 1.0)
    assert not bool(r1.any()) and not bool(np.asarray(r0).any())
    assert np.all(s1.numpy() == 0.0) and np.all(np.asarray(s0) == 0.0)


def test_k10_rejects_mismatched_shapes():
    low, WxT, Wy = k10_inputs(64, 128, K10_CASES[0][2], seed=0)
    with pytest.raises(ValueError, match="WxT"):
        pass1_stats(t(low), t(WxT[:-1]), t(Wy), (0, 0, 48, 40), 0.0, 1.0)
    with pytest.raises(ValueError, match="Wy"):
        pass1_stats(t(low), t(WxT), t(Wy[:, :-1]), (0, 0, 48, 40), 0.0, 1.0)


# ---- the kernel check's work model and result schema (no card needed) --------


@pytest.mark.parametrize("name,shape,ops,nbytes,ms,by", [
    # K2: 16 heads x [4096, 80], G = 64: 4 S^2 hd BH operations; q, k, v, out
    # in bf16 (41.9 MB) and the two f32 rel terms (33.6 MB)
    ("flash_attention_fused", dict(BH=16, S=4096, hd=80, G=64, esize=2),
     4 * 4096 * 4096 * 80 * 16, 4 * 16 * 4096 * 80 * 2 + 2 * 16 * 4096 * 64 * 4, 0.087, "operations"),
    # K1: 400 window-heads x [196, 80], G = 14: 50.2 MB + 8.8 MB
    ("flash_windowed_fused", dict(BH=400, S=196, hd=80, G=14, esize=2),
     4 * 196 * 196 * 80 * 400, 4 * 400 * 196 * 80 * 2 + 2 * 400 * 196 * 14 * 4, 0.018, "bytes"),
    # K6: 1536 stream-heads x [197, 64], one f32 bias row per stream
    ("clip_attention", dict(BH=1536, S=197, hd=64, N=128, esize=2),
     4 * 197 * 197 * 64 * 1536, 4 * 1536 * 197 * 64 * 2 + 128 * 197 * 4, 0.046, "bytes"),
])
def test_kernel_work_matches_hand_worked_figures(name, shape, ops, nbytes, ms, by):
    from hybridgl_tpu_torch.tools.check_kernels import bound_ms, kernel_work

    assert kernel_work(name, **shape) == (ops, nbytes)
    got_ms, got_by = bound_ms(ops, nbytes)
    assert got_by == by and abs(got_ms - ms) < 0.0006
    assert got_ms == max(ops / 989e12, nbytes / 3.35e12) * 1e3


def test_kernel_work_covers_every_kernel():
    """Every kernel of the table has a work model; the decoder and pass-1
    figures land where a hand count puts them."""
    from hybridgl_tpu_torch.kernels import GLUE
    from hybridgl_tpu_torch.tools.check_kernels import KERNELS, kernel_work

    vit_h = dict(T=4096, D=1280, esize=2)  # one image's 64 x 64 grid

    shapes = {
        "flash_windowed_fused": dict(BH=400, S=196, hd=80, G=14, esize=2),
        "flash_attention_fused": dict(BH=16, S=4096, hd=80, G=64, esize=2),
        "flash_attention_rel_pos": dict(BH=16, S=4096, hd=80, G=64, esize=2),
        "clip_attention": dict(BH=1536, S=197, hd=64, N=128, esize=2),
        "pass1_stats_half": dict(B=192, n=256, C=640, dh=480, dw=640, esize=2),
        "pass1_stats": dict(B=48, n=256, n2=256, C=1024, dh=451, dw=633, esize=2),
        "i2t_ln_then_t2i": dict(B=64, S=4096, C=256, Cq=256, GT=64),
        "i2t_ln_update": dict(B=128, S=4096, C=256, Cq=256, GT=64),
        "t2i_ctx": dict(B=128, S=4096, C=256, Cq=256, GT=64),
        "upscale_hyper_blocked": dict(B=64, S=4096, C=256, c4=64, c8=32, m=3),
        "nms": dict(N=128, read_words=138),
        **{name: dict(T=64 * 197, D=768, esize=2) for name in GLUE},
        "bias_quick_gelu": dict(T=64 * 197, F=3072, esize=2),
        "gem_attention": dict(BH=16, S=1025, hd=64, esize=2, ensemble=True, iters=1),
        "sam_layer_norm": dict(vit_h, To=4900),
        "sam_qkv_heads": dict(B=25, S=196, D=1280, H=16, G=14),
        "sam_merge_heads": dict(T=4900, D=1280),
        "sam_residual_layer_norm": dict(vit_h, To=4900),
        "sam_residual_add": vit_h,
        "sam_bias_gelu": dict(T=4096, F=5120),
    }
    assert set(shapes) == set(KERNELS)
    work = {name: kernel_work(name, **shape) for name, shape in shapes.items()}
    assert all(ops > 0 and nbytes > 0 for name, (ops, nbytes) in work.items()
               if name not in ("merge_heads", "sam_merge_heads"))
    # the glue moves bytes: a block's at bucket 32, ~0.47 GB (twice the rows of
    # D through the two residual + LayerNorm kernels, three times the rows of
    # D in and out of the head split, once in and out of the merge, four
    # times the rows of D in and out of the QuickGELU)
    block = sum(work[k][1] for k in ("qkv_heads", "merge_heads", "bias_quick_gelu")) + 2 * work["residual_layer_norm"][1]
    assert 0.46e9 < block < 0.47e9
    assert work["flash_attention_rel_pos"] == work["flash_attention_fused"]
    # the SAM glue moves bytes too: a windowed ViT-H block's ~281 MB of one image (the qkv product in and
    # the heads out, 75 MB, with the f32 rel terms, 8.8 MB; the merge in the padded layout, 25 MB; two
    # residuals and LayerNorms, 44 MB each; the 4096 x 5120 GELU in and out, 84 MB)
    sam = ("sam_qkv_heads", "sam_merge_heads", "sam_residual_layer_norm", "sam_residual_layer_norm", "sam_bias_gelu")
    assert 0.28e9 < sum(work[k][1] for k in sam) < 0.285e9
    # K3 pass B: four [S, 64] x [64 or 256, 256] products per prompt, ~34 GFLOP;
    # the per-prompt keys in and out (268 MB) dominate its 285 MB
    assert work["i2t_ln_then_t2i"][0] == 2 * 64 * 4096 * 64 * (256 + 3 * 256)
    assert 2 * 64 * 4096 * 256 * 2 < work["i2t_ln_then_t2i"][1] < 1.1 * 2 * 64 * 4096 * 256 * 2
    # a shared query side is read once, not once per prompt
    shared = kernel_work("i2t_ln_then_t2i", B=64, S=4096, C=256, Cq=128, GT=64, shared=True)
    assert shared[1] < work["i2t_ln_then_t2i"][1] - 64 * 4096 * 256
    # K7 + K8 do K3's operations between them
    assert work["i2t_ln_update"][0] + work["t2i_ctx"][0] == 2 * work["i2t_ln_then_t2i"][0]
    # K4: two deconvs and the hyper rows per source pixel, ~52 GFLOP
    assert work["upscale_hyper_blocked"][0] == 64 * 4096 * (2 * 256 * 256 + 4 * 2 * 64 * 128 + 16 * 2 * 32 * 3)
    # K5: only the window's rows and columns are computed
    assert work["pass1_stats_half"][0] == 2 * 192 * 480 * 640 * 256
    assert kernel_work("pass1_stats_half", B=192, n=256, C=1024, dh=162, dw=162, esize=2)[0] < work["pass1_stats_half"][0] / 5
    # NMS: ~15 operations an IoU of the upper triangle; boxes, valid, the mask's 64 x 2 + 64 x 1 words of upper
    # triangle written and 138 read, keep and the count
    assert work["nms"] == (15 * 128 * 127 // 2, 16 * 128 + 128 + 8 * (192 + 138) + 128 + 4)
    # GEM's attention at ViT-L/14@336: the trunk's and the three streams' 4 S^2 hd operations each (~17.2 GFLOP);
    # q, k, v in and the two merged outputs out; each update pass adds three attentions
    assert work["gem_attention"] == (4 * 4 * 16 * 1025**2 * 64, 5 * 16 * 1025 * 64 * 2)
    trunk = kernel_work("gem_attention", BH=16, S=1025, hd=64, esize=2, ensemble=False)
    assert trunk == (work["gem_attention"][0] // 4, 4 * 16 * 1025 * 64 * 2)
    assert kernel_work("gem_attention", BH=16, S=1025, hd=64, esize=2, ensemble=True, iters=2)[0] == 7 * trunk[0]
    with pytest.raises(ValueError):
        kernel_work("no_such_kernel")


def test_run_checks_schema_and_refusal():
    """run_checks reports library_ms and bound_ms for every kernel, and
    refuses to run without a card."""
    import inspect

    from hybridgl_tpu_torch.tools import check_kernels

    assert {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "ok"} == set(check_kernels.RESULT_KEYS)
    record = inspect.getsource(check_kernels._Run.record)
    assert all(f"{key}=" in record for key in check_kernels.RESULT_KEYS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            check_kernels.run_checks()
        assert check_kernels.main([]) == 2
