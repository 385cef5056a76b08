"""Check every CUDA kernel of the port against its plain version on the card.

The counterpart of the reference's ``tools/check_tpu_kernels.py``: each of
the ten kernels runs at production geometry with bf16 inputs and TF32 off,
beside its plain PyTorch version on the same inputs, and prints one
PASS/FAIL line with its median time and the plain version's (CUDA events
around a batch of back-to-back calls, :func:`time_ms`). K3 and K4 have two
kernels each: the tensor-core one is checked at B = 64 and 128, the
CUDA-core one in bf16 at a shape the tensor-core dispatch refuses (ragged S,
m = 2) and in f32 at half width (at full width its f32 operands do not fit
in shared memory), and both are held at SamPredictor's shapes (B = 1: K3 at 7
tokens and, on its split route, at 9; K4 at m = 3 and 1). K5 and K6 have two each as well: K5's tensor-core kernel
at the three served windows in bf16, its CUDA-core kernel in f32 and in bf16
at n = 200, which the tensor-core dispatch refuses; K6's tensor-core kernel
at [1536, 197, 64] in bf16 with query row 0 (the only biased row) also held
on its own, its CUDA-core kernel in f32 and at hd = 32. K10 likewise: its
tensor-core kernel at both shapes in bf16, its CUDA-core kernel in f32 and in
bf16 at n = 200, with the time of ``half_transform`` + K5 on the same inputs
beside it (no single PyTorch call computes K10; that pair is the port's other
route to the same numbers). Each time stands beside the kernel's
bound, the least time the card could take for the same work
(:func:`kernel_work` and :func:`bound_ms`: operations over the bf16
tensor-core peak or bytes over the memory rate, whichever is larger), and,
for the four attention kernels, beside the one PyTorch call that computes
the same function (``scaled_dot_product_attention`` with the bias
materialised as ``attn_mask``). That call is a yardstick only: nothing else
in the port calls it. The run ends with ``ALL PASS`` or ``FAILURES``; the
exit code is 0 only if every kernel passed.

    python -m hybridgl_tpu_torch.tools.check_kernels [name ...]   (default: all)

Bars (the reference check's, ``tools/check_tpu_kernels.py:144-183``):
  * attention-type outputs: cos >= 0.999 and mean|d|/mean|plain| < 0.02;
  * decoder logits (K4): max|d| < 0.1 and > 99.5% sign agreement;
  * pass-1 stats: stability |d| <= 1e-3 and box edges within 1 px in bf16;
    in f32 (``HYBRIDGL_STATS_BF16=0``) equal box edges and stability |d| <=
    1e-4: the f32 sums differ only in order, which can move a pixel lying
    within ~1e-6 of a threshold, and each such pixel moves a stability
    score by 1/lo (lo ~ 1e4-1e5 pixels here).

Geometry: SAM ViT-H attention (K1: 25 windows x 16 heads, S = 196, G = 14;
K2 and K9: 16 heads, S = 4096, G = 64, hd = 80), CLIP ViT-B/16 (K6: 128
streams x 12 heads, L = 197, hd = 64), the SAM decoder (C = 256, 8 heads x
tp 8, S = 4096; B = 64 and 128 for K3/K4, 128 for K7/K8), pass 1 (K5: 192 RefCOCO
candidates at C = 640, and PhraseCut's layer-1 crop window and full-image
window at C = 1024; K10: 16
points x 3 masks at C = 1024 and window (17, 5, 451, 633), and 192
candidates at C = 640). The check needs a CUDA card; it refuses to run
without one.
"""

from __future__ import annotations

import os
import statistics
import sys

import torch

from ..utils.flops import PEAK_FLOPS_BY_DEVICE

# name -> (CUDA source of the kernel the main path launches, the TPU kernel it replaces)
KERNELS = {
    "flash_windowed_fused": ("hybridgl_tpu_torch/csrc/attention_wgmma.cu", "hybridgl_tpu/kernels/flash_attention.py:276"),
    "flash_attention_fused": ("hybridgl_tpu_torch/csrc/attention_wgmma.cu", "hybridgl_tpu/kernels/flash_attention.py:171"),
    "pass1_stats_half": ("hybridgl_tpu_torch/csrc/pass1_stats_wgmma.cu", "hybridgl_tpu/kernels/pass1_stats.py:257"),
    "clip_attention": ("hybridgl_tpu_torch/csrc/attention_wgmma.cu", "hybridgl_tpu/kernels/clip_attention.py:78"),
    "i2t_ln_then_t2i": ("hybridgl_tpu_torch/csrc/decoder_attn_wgmma.cu", "hybridgl_tpu/kernels/decoder_pass.py:209"),
    "upscale_hyper_blocked": ("hybridgl_tpu_torch/csrc/upscale_hyper_wgmma.cu", "hybridgl_tpu/kernels/upscale_hyper.py:153"),
    "i2t_ln_update": ("hybridgl_tpu_torch/csrc/decoder_attn_wgmma.cu", "hybridgl_tpu/kernels/decoder_attn.py:95"),
    "t2i_ctx": ("hybridgl_tpu_torch/csrc/decoder_attn_wgmma.cu", "hybridgl_tpu/kernels/decoder_attn_t2i.py:82"),
    "flash_attention_rel_pos": ("hybridgl_tpu_torch/csrc/attention_wgmma.cu", "hybridgl_tpu/kernels/flash_attention.py:78"),
    "pass1_stats": ("hybridgl_tpu_torch/csrc/pass1_stats_wgmma.cu", "hybridgl_tpu/kernels/pass1_stats.py:152"),
}


# published peaks of one H100 SXM: dense bf16 on the tensor cores (the
# FLOP model's table), HBM3
PEAK_BF16_FLOPS = PEAK_FLOPS_BY_DEVICE["NVIDIA H100"]
PEAK_BYTES_PER_S = 3.35e12


def kernel_work(name: str, **d) -> tuple[int, int]:
    """(operations, bytes) one call of kernel ``name`` needs at the shapes
    ``d``: multiply-adds count 2, every input byte is read once and every
    output byte written once. Where the work depends on the data (the
    placement window of the pass-1 stats) it is what these inputs need.

    Shapes: the attention kernels take BH, S, hd, esize (bytes per q/k/v
    element) and G (rel-pos) or N (CLS-row bias rows); the pass-1 stats B, n,
    C, dh, dw (window extent), esize (stats dtype) and, full mode, n2; the
    decoder kernels B, S, C, Cq, GT, shared (qside and base are [1, S, .]);
    K4 B, S, C, c4, c8, m."""
    if name in ("flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos"):
        BH, S, hd, G, e = d["BH"], d["S"], d["hd"], d["G"], d["esize"]
        return 4 * BH * S * S * hd, 4 * BH * S * hd * e + 2 * BH * S * G * 4
    if name == "clip_attention":
        BH, S, hd, N, e = d["BH"], d["S"], d["hd"], d["N"], d["esize"]
        return 4 * BH * S * S * hd, 4 * BH * S * hd * e + N * S * 4
    if name in ("pass1_stats_half", "pass1_stats"):
        B, n, C, dh, dw, e = d["B"], d["n"], d["C"], d["dh"], d["dw"], d["esize"]
        out = B * 2 * 4 + 2 * B * C  # the two counts, the row and column flags
        if name == "pass1_stats_half":  # tmp's window columns, Wy's window rows
            return 2 * B * dh * dw * n, B * n * dw * e + dh * n * e + out
        n2 = d["n2"]
        return 2 * B * n * n2 * dw + 2 * B * dh * dw * n, B * n * n2 * e + n2 * dw * e + dh * n * e + out
    if name in ("i2t_ln_then_t2i", "i2t_ln_update", "t2i_ctx"):
        B, S, C, Cq, GT, e = d["B"], d["S"], d["C"], d["Cq"], d["GT"], d.get("esize", 2)
        rows = 1 if d.get("shared") else B
        small = B * Cq * GT * 4 + B * GT * 4 + B * GT * C * e + 3 * C * 4  # w, off, vo, const and LN
        if name == "t2i_ctx":  # scores against qw, then the context sum
            return 4 * B * S * GT * C, B * S * C * e + S * C * e + B * C * GT * 4 + B * GT * C * 4
        i2t_ops = 2 * B * S * GT * (Cq + C)
        i2t_bytes = rows * S * Cq * e + (S * C * e if d.get("shared") else 0) + S * C * e + small + B * S * C * e
        if name == "i2t_ln_update":
            return i2t_ops, i2t_bytes
        return i2t_ops + 4 * B * S * GT * C, i2t_bytes + B * C * GT * 4 + B * GT * C * 4
    if name == "upscale_hyper_blocked":
        B, S, C, c4, c8, m = d["B"], d["S"], d["C"], d["c4"], d["c8"], d["m"]
        ops = B * S * (2 * C * 4 * c4 + 4 * 2 * c4 * 4 * c8 + 16 * 2 * c8 * m)
        e = d.get("esize", 2)  # src, the deconv weights and the hyper rows come in the stream dtype
        return ops, (B * S * C + C * 4 * c4 + c4 * 4 * c8 + B * m * c8) * e + B * m * 16 * S * 4
    raise ValueError(f"unknown kernel {name}")


def bound_ms(operations: int, nbytes: int) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    by_ops, by_bytes = operations / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call, in ms, after two warm-up calls.
    Each event pair brackets a batch of calls (as many as fit 20 ms, at most
    20) queued behind a device-side sleep, so that the calls run back to
    back and the host's launch gap (~30 us, a tenth of a short kernel) is
    not in the time; the time of the wrapper's own preparatory kernels is."""
    for _ in range(2):
        fn()

    def timed(n, sleep_cycles):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)  # the host queues the batch while the card waits
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    one = timed(1, 0)
    batch = max(1, min(20, int(20.0 / max(one, 1e-3))))
    if batch == 1:
        return statistics.median([one] + [timed(1, 0) for _ in range(reps - 1)])
    return statistics.median(timed(batch, 20_000_000) for _ in range(reps))


class _Run:
    """Inputs from one seeded generator on the card, and the verdicts."""

    def __init__(self, dev, log):
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(1)
        self.log = log
        self.results = {}

    def randn(self, *shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=self.gen, device=self.dev) * std).to(dtype)

    def verdict(self, label, ok, detail):
        self.log(f"{'PASS' if ok else 'FAIL'} {label}: {detail}")
        return ok

    def attention(self, label, got, want):
        """(ok, max|d|) under the attention bar."""
        g, w = got.float().flatten(), want.float().flatten()
        d = (g - w).abs()
        finite = bool(g.isfinite().all())
        cos = float((g @ w) / (g.norm() * w.norm() + 1e-30))
        rel = float(d.mean() / (w.abs().mean() + 1e-30))
        ok = finite and cos >= 0.999 and rel < 0.02
        self.verdict(label, ok, f"cos {cos:.6f} mean|d|/mean|plain| {rel:.5f} max|d| {float(d.max()):.5f}"
                     + ("" if finite else " NON-FINITE"))
        return ok, float(d.max())

    def record(self, name, ok, err, kernel, plain, shape, work, library=None):
        """Times the kernel, its plain version and, where there is one, the
        library call; ``work`` is :func:`kernel_work`'s shape arguments."""
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        library_ms = time_ms(library) if library is not None else None
        bound, by = bound_ms(*kernel_work(name, **work))
        self.log(f"  {name} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
                 + (f"{library_ms:.3f} ms" if library is not None else "no single call")
                 + f", bound {bound:.4f} ms by {by} ({100 * bound / ms:.1f}% of bound)")
        prev = self.results.get(name)
        if prev is None:
            self.results[name] = dict(ok=ok, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                      library_ms=library_ms)
        else:  # a second geometry of the same kernel: the JSON keeps the first's times
            prev["ok"] = prev["ok"] and ok
            prev["max_abs_err"] = max(prev["max_abs_err"], err)


def _sdpa(q, k, v, mask, scale):
    """The library yardstick: one fused-attention call with the bias as a mask."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _rel_pos(run: _Run):
    """K1, K2 and K9 at ViT-H widths, nonzero rel terms, hd = 80. The
    library call reads the [BH, S, S] bias in bf16 (537 MB for K2 and K9),
    built outside the timed region."""
    from ..kernels.flash_attention import (
        flash_attention_fused,
        flash_attention_rel_pos,
        flash_windowed_fused,
        reference_attention_rel_pos,
    )

    hd = 80
    scale = hd**-0.5
    for name, BH, G in (("flash_windowed_fused", 25 * 16, 14), ("flash_attention_fused", 16, 64),
                        ("flash_attention_rel_pos", 16, 64)):
        S = G * G
        q, k, v = run.randn(BH, S, hd), run.randn(BH, S, hd), run.randn(BH, S, hd)
        rh = run.randn(BH, S, G, std=0.5, dtype=torch.float32)
        rw = run.randn(BH, S, G, std=0.5, dtype=torch.float32)
        if name == "flash_attention_rel_pos":  # pre-scaled q, the TPU kernel's tiles
            qs = (q.float() * scale).to(q.dtype)
            kernel = lambda: flash_attention_rel_pos(qs, k, v, rh, rw, G, block_q=256, block_k=512)  # noqa: E731
            plain = lambda: reference_attention_rel_pos(qs, k, v, rh, rw, G, 1.0)  # noqa: E731
        else:
            fn = flash_windowed_fused if name == "flash_windowed_fused" else flash_attention_fused
            kernel = lambda: fn(q, k, v, rh, rw, G, scale)  # noqa: E731
            plain = lambda: reference_attention_rel_pos(q, k, v, rh, rw, G, scale)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        ok, err = run.attention(name, got, want)
        del got, want
        mask = (rh[:, :, :, None] + rw[:, :, None, :]).reshape(BH, S, S).to(q.dtype)
        lq, lscale = (qs, 1.0) if name == "flash_attention_rel_pos" else (q, scale)
        run.record(name, ok, err, kernel, plain, f"[{BH}, {S}, {hd}] bf16",
                   dict(BH=BH, S=S, hd=hd, G=G, esize=2), library=lambda: _sdpa(lq, k, v, mask, lscale))
        del mask
        torch.cuda.empty_cache()


def _clip(run: _Run):
    """K6: 2P = 128 crop streams x 12 heads, L = 197, hd = 64; the CLS-row
    bias masks about half the patches with finfo(float32).min. bf16 on the
    tensor-core kernel, with query row 0 of every head (the only biased row)
    also held on its own; then the CUDA-core kernel in f32 and at hd = 32."""
    from ..kernels.clip_attention import clip_attention, reference_clip_attention, variant

    N, H, L = 128, 12, 197
    for hd, dtype, want_kind in ((64, torch.bfloat16, "wgmma"), (64, torch.float32, "cuda-core"),
                                 (32, torch.bfloat16, "cuda-core")):
        name = str(dtype).split(".")[-1]
        q, k, v = (run.randn(N * H, L, hd, dtype=dtype) for _ in range(3))
        allowed = torch.rand((N, L), generator=run.gen, device=run.dev) > 0.5
        allowed[:, 0] = True
        bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min).float().contiguous()
        scale = hd**-0.5
        kernel = lambda: clip_attention(q, k, v, bias, H, scale)  # noqa: E731
        plain = lambda: reference_clip_attention(q, k, v, bias, H, scale)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        kind = variant(dtype, L, hd)
        label = f"clip_attention ({kind}, hd = {hd}, {name})"
        ok_v = run.verdict(f"{label} kernel", kind == want_kind, kind)
        ok, err = run.attention(label, got, want)
        ok_0, err_0 = run.attention(f"{label} row 0", got[:, 0], want[:, 0])
        # without a bias row 0 must differ: the bias is really applied
        ok_b = run.verdict(f"{label} bias applied", not torch.allclose(
            got[:, 0].float(), clip_attention(q, k, v, None, H, scale)[:, 0].float(), atol=1e-2), "row 0 moves with the bias")
        del got, want
        library = None
        if dtype == torch.bfloat16:
            mask = torch.zeros((N, H, L, L), dtype=q.dtype, device=run.dev)
            mask[:, :, 0, :] = bias[:, None, :].to(q.dtype)  # the CLS row only
            mask = mask.reshape(N * H, L, L)
            library = lambda: _sdpa(q, k, v, mask, scale)  # noqa: E731
        run.record("clip_attention", ok_v and ok and ok_0 and ok_b, max(err, err_0), kernel, plain,
                   f"({kind}) [{N * H}, {L}, {hd}] {name}",
                   dict(BH=N * H, S=L, hd=hd, N=N, esize=q.element_size()), library=library)
        del q, k, v
        if library is not None:
            del mask, library
        torch.cuda.empty_cache()


def _stats_verdict(run: _Run, label, got, want, exact):
    """(ok, stability max|d|) under the pass-1 bar (``exact``: the f32 one)."""
    from ..kernels.masks import box_from_profiles

    (stab, ra, ca), (stab0, ra0, ca0) = got, want
    ds = float((stab - stab0).abs().max())
    db = float((box_from_profiles(ra, ca) - box_from_profiles(ra0, ca0)).abs().max())
    finite = bool(torch.isfinite(stab).all())
    ok = finite and bool(ra0.any()) and (ds <= 1e-4 and db == 0.0 if exact else ds <= 1e-3 and db <= 1.0)
    run.verdict(label, ok, f"stability max|d| {ds:.2e}, box edge max|d| {db:.1f} px, "
                f"live rows {int(ra0.any(-1).sum())}/{ra0.shape[0]}")
    return ok, ds


def _smooth_logits(run: _Run, B, n):
    """Decoder-like low-res logits: a smooth field plus a little noise."""
    coarse = torch.randn((B, 1, 12, 12), generator=run.gen, device=run.dev) * 4.0
    low = torch.nn.functional.interpolate(coarse, size=(n, n), mode="bilinear")[:, 0]
    return low + torch.randn((B, n, n), generator=run.gen, device=run.dev) * 0.1


def _stats_dtype_env(bf16: bool):
    os.environ["HYBRIDGL_STATS_BF16"] = "1" if bf16 else "0"


def _pass1(run: _Run):
    """K5 and K10, bf16 stats (the default) and f32."""
    from ..kernels.pass1_stats import (
        half_transform,
        pass1_stats,
        pass1_stats_half,
        reference_pass1_stats_half,
        stats_dtype,
        variant,
        variant_full,
    )
    from ..kernels.resize import _composed_axis_weights

    saved = os.environ.get("HYBRIDGL_STATS_BF16")
    try:
        # RefCOCO: 64 points x 3 masks of 256^2 logits placed into the 640
        # canonical frame of a 480x640 image (rh, rw = 768, 1024)
        Bc, n, C, h, w = 192, 256, 640, 480, 640
        low = _smooth_logits(run, Bc, n)
        Wy = _composed_axis_weights(C, n, 1024, 768, 0, h, run.dev)
        Wx = _composed_axis_weights(C, n, 1024, 1024, 0, w, run.dev)
        window = (0, 0, h, w)
        # PhraseCut: the window of a layer-1 crop of a 480x640 image at C = 1024
        Cp, win_p = 1024, (159, 239, 321, 401)
        Wy_p = _composed_axis_weights(Cp, n, 1024, 820, win_p[0], win_p[2], run.dev)
        Wx_p = _composed_axis_weights(Cp, n, 1024, 1024, win_p[1], win_p[3], run.dev)
        # PhraseCut's full-image crop: the RefCOCO window in the 1024 frame
        Wy_f = _composed_axis_weights(Cp, n, 1024, 768, 0, h, run.dev)
        Wx_f = _composed_axis_weights(Cp, n, 1024, 1024, 0, w, run.dev)
        # n = 200: no whole number of wgmma K steps, so bf16 stays on the CUDA-core kernel
        n_r = 200
        low_n = _smooth_logits(run, Bc, n_r)
        Wy_n = _composed_axis_weights(C, n_r, 1024, 768, 0, h, run.dev)
        Wx_n = _composed_axis_weights(C, n_r, 1024, 1024, 0, w, run.dev)
        # the reference check's K10 geometry: 16 points x 3 masks, soft
        # nonnegative weights, window (17, 5, 451, 633)
        Br, Cr, win_r = 48, 1024, (17.0, 5.0, 451.0, 633.0)
        low_r = torch.randn((Br, n, n), generator=run.gen, device=run.dev)
        WxT_r = torch.relu(torch.randn((n, Cr), generator=run.gen, device=run.dev)) * 0.02
        Wy_r = torch.relu(torch.randn((Cr, n), generator=run.gen, device=run.dev)) * 0.02

        for bf16 in (True, False):
            _stats_dtype_env(bf16)
            tag = "bf16" if bf16 else "f32"
            shapes = [(low, Wy, Wx, window, f"C = {C}", "wgmma"),
                      (low, Wy_p, Wx_p, win_p, f"crop window, C = {Cp}", "wgmma"),
                      (low, Wy_f, Wx_f, window, f"full-image window, C = {Cp}", "wgmma")]
            if bf16:
                shapes.append((low_n, Wy_n, Wx_n, window, f"n = {n_r}, C = {C}", "cuda-core"))
            for (low_, Wy_, Wx_, win, note, want_kind) in shapes:
                tmp = half_transform(low_, Wx_.T)
                Wyd = Wy_.to(tmp.dtype)
                kind = variant(tmp.dtype, tmp.shape[1], Wy_.shape[0])
                want_kind = want_kind if bf16 else "cuda-core"
                kernel = lambda: pass1_stats_half(tmp, Wyd, win, 0.0, 1.0)  # noqa: E731
                plain = lambda: reference_pass1_stats_half(tmp, Wyd, win, 0.0, 1.0)  # noqa: E731
                label = f"pass1_stats_half ({kind}, {note}, {tag})"
                ok_v = run.verdict(f"{label} kernel", kind == want_kind, kind)
                ok, err = _stats_verdict(run, label, kernel(), plain(), not bf16)
                run.record("pass1_stats_half", ok and ok_v, err, kernel, plain,
                           f"({kind}) [{Bc}, {tmp.shape[1]}, {Wy_.shape[0]}] {note} {tag}",
                           dict(B=Bc, n=tmp.shape[1], C=Wy_.shape[0], dh=int(win[2]), dw=int(win[3]),
                                esize=tmp.element_size()))
            full = [(low_r, WxT_r, Wy_r, win_r, f"B = {Br}, C = {Cr}", "wgmma"),
                    (low, Wx.T.contiguous(), Wy, window, f"B = {Bc}, C = {C}", "wgmma")]
            if bf16:
                full.append((low_n, Wx_n.T.contiguous(), Wy_n, window, f"n = {n_r}, C = {C}", "cuda-core"))
            for (low_, WxT_, Wy_, win, note, want_kind) in full:
                dt = stats_dtype()
                low_d, WxT_d, Wy_d = low_.to(dt), WxT_.to(dt), Wy_.to(dt)
                kind = variant_full(dt, low_.shape[1], low_.shape[2], Wy_.shape[0])
                want_kind = want_kind if bf16 else "cuda-core"
                kernel = lambda: pass1_stats(low_d, WxT_d, Wy_d, win, 0.0, 1.0)  # noqa: E731
                plain = lambda: reference_pass1_stats_half(half_transform(low_d, WxT_d), Wy_d, win, 0.0, 1.0)  # noqa: E731
                label = f"pass1_stats ({kind}, {note}, {tag})"
                tc0 = pass1_stats.tc_launches
                got = kernel()
                took = "wgmma" if pass1_stats.tc_launches > tc0 else "cuda-core"
                ok_v = run.verdict(f"{label} kernel", kind == want_kind and took == want_kind, f"{kind}, launched {took}")
                ok, err = _stats_verdict(run, label, got, plain(), not bf16)
                run.record("pass1_stats", ok and ok_v, err, kernel, plain,
                           f"({kind}) low [{low_.shape[0]}, {low_.shape[1]}, {low_.shape[2]}] {note} {tag}",
                           dict(B=low_.shape[0], n=low_.shape[1], n2=low_.shape[2], C=Wy_.shape[0], dh=int(win[2]),
                                dw=int(win[3]), esize=low_d.element_size()))
                # the port's other route to the same numbers: one matmul, then K5
                pair = time_ms(lambda: pass1_stats_half(half_transform(low_d, WxT_d), Wy_d, win, 0.0, 1.0))
                run.log(f"  pass1_stats {note} {tag}: half_transform + pass1_stats_half {pair:.3f} ms")
                if bf16 and want_kind == "wgmma":
                    run.results["pass1_stats"].setdefault("pair_ms", pair)
    finally:
        if saved is None:
            os.environ.pop("HYBRIDGL_STATS_BF16", None)
        else:
            os.environ["HYBRIDGL_STATS_BF16"] = saved


def _i2t_ops(run: _Run, B, Cq, C=256, heads=8, tp=8, T=7, dtype=torch.bfloat16):
    """Token-side operands of K3/K7 at SAM's decoder widths: w [B, Cq, 64]
    f32, off (-1e30 on the padding lanes t >= T), vo [B, 64, C], const/LN."""
    f32 = torch.float32
    off = run.randn(B, heads, tp, std=0.5, dtype=f32)
    off[:, :, T:] = -1e30
    return dict(w=run.randn(B, Cq, heads * tp, std=Cq**-0.5 * 2, dtype=f32), off=off.reshape(B, -1),
                vo=run.randn(B, heads * tp, C, std=0.5, dtype=dtype), const=run.randn(C, std=0.1, dtype=f32),
                ln_scale=1.0 + run.randn(C, std=0.1, dtype=f32), ln_bias=run.randn(C, std=0.1, dtype=f32))


def _check_pass(run: _Run, label, B, S, shared, want_kind, C=256, dtype=torch.bfloat16, tp=8, T=7):
    """K3 in one operand form (pass A: shared once-projected queries [1, S,
    C/2], raw image and pe [1, S, C]; pass B: per-prompt keys [B, S, C])
    against its plain version; asserts the route the dispatch chose
    (``pass_route``) and the launches the call counted: one, or on the split
    route (tp = 16: T tokens over 8) one I2T launch on the CUDA cores and one
    T2I launch per 64 context columns on the tensor cores."""
    from ..kernels.decoder_attn import PASS, variant
    from ..kernels.decoder_pass import i2t_ln_then_t2i, pass_route, reference_i2t_ln_then_t2i, split_columns

    Cq = C // 2 if shared else C
    GT = 8 * tp
    pe = run.randn(1, S, C, dtype=dtype)
    ops = _i2t_ops(run, B, Cq, C, tp=tp, T=T, dtype=dtype)
    qside = run.randn(1 if shared else B, S, Cq, dtype=dtype)
    base = run.randn(1, S, C, dtype=dtype) if shared else qside
    qw = run.randn(B, C, GT, std=C**-0.5 * 2, dtype=torch.float32)
    qw.reshape(B, C, 8, tp)[..., T:] = 0.0  # the padding lanes' columns
    kind = pass_route(dtype, S, Cq, C, 8, tp, GT, shared)
    smem = variant(PASS, dtype, S, Cq, C, 8, tp, GT, not shared, not shared)[1]
    parts = GT // split_columns(C, GT)
    want_counts = {"wgmma": (1, 1), "cuda-core": (1, 0), "split": (1 + parts, parts)}[kind]

    def call(fn):
        return fn(qside, base, pe, **ops, qw_next=qw, heads=8, tp=tp, shared_qside=shared)

    before = (i2t_ln_then_t2i.launches, i2t_ln_then_t2i.tc_launches)
    keys, ctx = call(i2t_ln_then_t2i)
    counted = (i2t_ln_then_t2i.launches - before[0], i2t_ln_then_t2i.tc_launches - before[1])
    keys0, ctx0 = call(reference_i2t_ln_then_t2i)
    torch.cuda.synchronize()
    ok_v = run.verdict(f"i2t_ln_then_t2i {label} kernel", kind == want_kind and counted == want_counts,
                       f"{kind}, {smem} bytes of shared memory for one PASS block, launches {counted[0]} "
                       f"({counted[1]} on the tensor cores)")
    ok_k, err_k = run.attention(f"i2t_ln_then_t2i {label} keys'", keys, keys0)
    ok_c, err_c = run.attention(f"i2t_ln_then_t2i {label} ctx", ctx, ctx0)
    del keys, ctx, keys0, ctx0
    name = str(dtype).split(".")[-1]
    run.record("i2t_ln_then_t2i", ok_v and ok_k and ok_c, max(err_k, err_c), lambda: call(i2t_ln_then_t2i),
               lambda: call(reference_i2t_ln_then_t2i),
               f"{label} ({kind}) B = {B}, qside [{qside.shape[0]}, {S}, {Cq}] {name}",
               dict(B=B, S=S, C=C, Cq=Cq, GT=GT, shared=shared, esize=qside.element_size()))


def _check_upscale(run: _Run, label, B, m, want_kind, S=4096, C=256, dtype=torch.bfloat16):
    """K4 at c4 = C / 4, c8 = C / 8 against its plain version; asserts the
    kernel the dispatch chose."""
    from ..kernels.upscale_hyper import reference_upscale_hyper, upscale_hyper, variant

    f32, c4, c8 = torch.float32, C // 4, C // 8
    # the deconv weights arrive rounded to the stream dtype, as the decoder hands them over
    args = (run.randn(B, S, C, dtype=dtype), run.randn(C, 4 * c4, std=C**-0.5, dtype=dtype),
            run.randn(c4, std=0.1, dtype=f32), 1.0 + run.randn(c4, std=0.1, dtype=f32),
            run.randn(c4, std=0.1, dtype=f32), run.randn(c4, 4 * c8, std=c4**-0.5, dtype=dtype),
            run.randn(c8, std=0.1, dtype=f32), run.randn(B, m, c8, std=0.5, dtype=dtype))
    kind, smem = variant(dtype, C, c4, c8, m)
    got, want = upscale_hyper(*args), reference_upscale_hyper(*args)
    torch.cuda.synchronize()
    d = float((got - want).abs().max())
    agree = float(((got > 0) == (want > 0)).float().mean())
    ok = run.verdict(f"upscale_hyper_blocked {label}",
                     kind == want_kind and bool(torch.isfinite(got).all()) and d < 0.1 and agree > 0.995,
                     f"{kind}, {smem} bytes of shared memory, logits max|d| {d:.5f}, sign agreement {agree:.6f}")
    del got, want
    name = str(dtype).split(".")[-1]
    g4 = 4 * int(S**0.5)
    run.record("upscale_hyper_blocked", ok, d, lambda: upscale_hyper(*args), lambda: reference_upscale_hyper(*args),
               f"{label} ({kind}) src [{B}, {S}, {C}] {name} -> [{B}, {m}, {g4}, {g4}] f32",
               dict(B=B, S=S, C=C, c4=c4, c8=c8, m=m, esize=args[0].element_size()))


def _decoder(run: _Run):
    """K3, K7, K8 and K4 at full width: C = 256, 8 heads, tp = 8 (GT = 64),
    S = 4096; B = 64 (a pass-1 chunk) and 128 for K3/K4, B = 128 (PhraseCut's
    pass 2) for K7/K8, and B = 1 (SamPredictor: K3 at 7 and at 9 tokens, K4 at
    m = 3 and 1). The JSON line keeps the first geometry of each kernel: K3
    pass B at B = 64, K4 at B = 64, m = 3."""
    from ..kernels.decoder_attn import i2t_ln_update, reference_i2t_ln_update
    from ..kernels.decoder_attn_t2i import reference_t2i_ctx, t2i_ctx

    f32, S, C = torch.float32, 4096, 256
    # K3 on the tensor cores, then its CUDA-core kernel: bf16 at a ragged S
    # the tensor-core dispatch refuses, and f32 at half width (at C = 256 the
    # f32 token-side operands do not fit in shared memory)
    _check_pass(run, "pass B", 64, S, False, "wgmma")
    _check_pass(run, "pass A", 64, S, True, "wgmma")
    _check_pass(run, "pass B, B = 128", 128, S, False, "wgmma")
    _check_pass(run, "pass A, B = 128", 128, S, True, "wgmma")
    _check_pass(run, "pass B, ragged S", 64, S - 32, False, "cuda-core")
    _check_pass(run, "pass B, f32 at C = 128", 128, S, False, "cuda-core", C=128, dtype=f32)
    # SamPredictor's shapes: one prompt; a point or a box alone gives 7 tokens
    # (tp = 8), a box with two points 9 (tp = 16): the split route
    _check_pass(run, "pass B, B = 1", 1, S, False, "wgmma")
    _check_pass(run, "pass A, B = 1", 1, S, True, "wgmma")
    _check_pass(run, "pass B, B = 1, 9 tokens", 1, S, False, "split", tp=16, T=9)
    _check_pass(run, "pass A, B = 1, 9 tokens", 1, S, True, "split", tp=16, T=9)
    torch.cuda.empty_cache()

    # K7 and K8 at PhraseCut's pass 2: P = 128 survivors, per-prompt keys
    B = 128
    pe = run.randn(1, S, C)
    keys = run.randn(B, S, C)
    ops = _i2t_ops(run, B, C)
    kernel = lambda: i2t_ln_update(keys, keys, **ops, heads=8, tp=8, pe=pe)  # noqa: E731
    plain = lambda: reference_i2t_ln_update(keys, keys, **ops, heads=8, tp=8, pe=pe)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ok, err = run.attention("i2t_ln_update", got, want)
    del got, want
    run.record("i2t_ln_update", ok, err, kernel, plain, f"B = {B}, keys [{B}, {S}, {C}] + pe bf16",
               dict(B=B, S=S, C=C, Cq=C, GT=64))
    qw = run.randn(B, C, 64, std=C**-0.5 * 2, dtype=f32)
    qw[:, :, 7::8] = 0.0  # padding columns
    kernel = lambda: t2i_ctx(keys, pe, qw)  # noqa: E731
    plain = lambda: reference_t2i_ctx(keys, pe, qw)  # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    ok, err = run.attention("t2i_ctx", got, want)
    del got, want
    run.record("t2i_ctx", ok, err, kernel, plain, f"B = {B}, keys [{B}, {S}, {C}] bf16 -> [{B}, 64, {C}]",
               dict(B=B, S=S, C=C, Cq=C, GT=64))
    del keys
    torch.cuda.empty_cache()

    # K4: a pass-1 chunk's tail (B = 64, m = 3), PhraseCut's pass 2 (B = 128),
    # the single-mask form, then the CUDA-core kernel: bf16 at m = 2, which the
    # tensor-core dispatch refuses, and f32 at half width (f32 w1 at C = 256
    # alone is 256 KB of shared memory)
    _check_upscale(run, "B = 64, m = 3", 64, 3, "wgmma")
    _check_upscale(run, "B = 128, m = 3", 128, 3, "wgmma")
    _check_upscale(run, "B = 128, m = 1", 128, 1, "wgmma")
    _check_upscale(run, "B = 1, m = 3", 1, 3, "wgmma")  # SamPredictor, multimask_output both ways
    _check_upscale(run, "B = 1, m = 1", 1, 1, "wgmma")
    _check_upscale(run, "B = 64, m = 2", 64, 2, "cuda-core")
    _check_upscale(run, "B = 128, f32 at C = 128", 128, 3, "cuda-core", C=128, dtype=f32)


# what run_checks reports for each kernel (library_ms is None where no
# single PyTorch call computes the kernel's function)
RESULT_KEYS = ("ok", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

# each group checks the kernels it names
_GROUPS = (
    (("flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos"), _rel_pos),
    (("clip_attention",), _clip),
    (("pass1_stats_half", "pass1_stats"), _pass1),
    (("i2t_ln_then_t2i", "i2t_ln_update", "t2i_ctx", "upscale_hyper_blocked"), _decoder),
)


def run_checks(names=None, log=print) -> dict:
    """Check the named kernels (default: all ten) on the card.

    Returns {name: dict of RESULT_KEYS}; raises where no CUDA card is
    present."""
    if not torch.cuda.is_available():
        raise RuntimeError("check_kernels needs a CUDA card; torch.cuda.is_available() is False")
    unknown = set(names or ()) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}; choose from {list(KERNELS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = _Run(torch.device("cuda"), log)
    wanted = set(names or KERNELS)
    for group, check in _GROUPS:
        if wanted & set(group):
            check(run)
            torch.cuda.empty_cache()
    return {k: v for k, v in run.results.items() if k in wanted}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("check_kernels: no CUDA card (torch.cuda.is_available() is False); nothing was checked",
              file=sys.stderr)
        return 2
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"card: {smi[0] if smi else torch.cuda.get_device_name(0)}", flush=True)
    results = run_checks(argv or None, log=lambda m: print(m, flush=True))
    failed = [k for k, v in results.items() if not v["ok"]]
    print("ALL PASS" if not failed else f"FAILURES: {failed}")
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main())
