"""Check every CUDA kernel of the port against its plain version on the card.

The counterpart of the reference's ``tools/check_tpu_kernels.py``: each of
the ten kernels that replace the TPU kernels runs at production geometry with
bf16 inputs and TF32 off,
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
at [1536, 197, 64] and CLIP ViT-L/14@336's [2048, 577, 64] in bf16 with query
row 0 (the only biased row) also held on its own, its CUDA-core kernel in f32
and at hd = 32. K10 likewise: its
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
in the port calls it. The port's own NMS kernel (``csrc/nms.cu``; the
reference's NMS is XLA) is checked the same way on f32 boxes, its bound
counted against the CUDA cores' f32 rate (no PyTorch call computes greedy
NMS). The port's fused glue of the CLIP block (``csrc/clip_glue.cu``; XLA
fuses it in the reference) is timed at ViT-B/16's trunk at proposal
buckets 32 and 64, its bound by bytes, and checked at the main path's
other rows (bucket 8, GEM, the text tower). The port's fused glue of the
SAM encoder block (``csrc/sam_glue.cu``; XLA fuses it in the reference) is
timed at ViT-H's windowed and global blocks of one image (25 windows of
196 x 1280 from a 64 -> 70 pad, the 4096 x 1280 grid, the 4096 x 5120
hidden state) and checked at five images, its bound by bytes (the rel-pos
products of its qkv kernel against the CUDA cores' f32 rate). GEM's attention
(``csrc/gem_attention.cu``; plain XLA in the reference) is timed at GEM's 785
and 1,025 tokens beside its plain version and beside the same function
from library calls (two ``scaled_dot_product_attention`` calls, the unit
rows and a mean: :func:`_gem_library`), the trunk with and without the
ensemble, against the plain version in f32 under the attention bar and, for
the ensemble, under its own bar on the part its scores decide. The run
ends with ``ALL PASS`` or ``FAILURES``; the exit code is 0 only if every
kernel passed.

    python -m hybridgl_tpu_torch.tools.check_kernels [name ...]   (default: all)

Bars (the reference check's, ``tools/check_tpu_kernels.py:144-183``):
  * attention-type outputs: cos >= 0.999 and mean|d|/mean|plain| < 0.02;
  * GEM's ensemble also: mean|d|/mean|plain| < ``ENSEMBLE_BAR`` on its
    score-dependent part (:func:`ensemble_score_error`);
  * decoder logits (K4): max|d| < 0.1 and > 99.5% sign agreement;
  * NMS: order, keep_sorted and num_kept exactly equal;
  * pass-1 stats: stability |d| <= 1e-3 and box edges within 1 px in bf16;
    in f32 (``HYBRIDGL_STATS_BF16=0``) equal box edges and stability |d| <=
    1e-4: the f32 sums differ only in order, which can move a pixel lying
    within ~1e-6 of a threshold, and each such pixel moves a stability
    score by 1/lo (lo ~ 1e4-1e5 pixels here).

Geometry: SAM ViT-H attention (K1: 25 windows x 16 heads, S = 196, G = 14;
K2 and K9: 16 heads, S = 4096, G = 64, hd = 80), CLIP ViT-B/16 (K6: 128
streams x 12 heads, L = 197, hd = 64; CLIP ViT-L/14@336: 128 streams x 16
heads, L = 577), the SAM decoder (C = 256, 8 heads x
tp 8, S = 4096; B = 64 and 128 for K3/K4, 128 for K7/K8), pass 1 (K5: 192 RefCOCO
candidates at C = 640, and PhraseCut's layer-1 crop window and full-image
window at C = 1024; K10: 16
points x 3 masks at C = 1024 and window (17, 5, 451, 633), and 192
candidates at C = 640), NMS (N = 192, 1,280, 3,072, 12,288 and a ragged
1,001 candidates, threshold 0.7). The check needs a CUDA card; it refuses to
run without one.
"""

from __future__ import annotations

import os
import statistics
import sys

import torch

from ..kernels import GLUE, SAM_GLUE
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
    # the port's own kernel: the reference's nms is an XLA program (the IoU matrix and a fori_loop sweep)
    "nms": ("hybridgl_tpu_torch/csrc/nms.cu", "hybridgl_tpu/kernels/nms.py:31"),
    # the port's own: GEM's attention, plain XLA in the reference (its _std_attention and self_self_attention)
    "gem_attention": ("hybridgl_tpu_torch/csrc/gem_attention.cu", "none: plain XLA in hybridgl_tpu/models/gem/gem.py"),
    # the port's own: the CLIP block's glue, which XLA fuses in the reference
    **{name: ("hybridgl_tpu_torch/csrc/clip_glue.cu", "none: XLA's fusions in hybridgl_tpu/models/clip/layers.py")
       for name in GLUE},
    # the port's own: the SAM encoder block's glue, which XLA fuses in the reference
    **{name: ("hybridgl_tpu_torch/csrc/sam_glue.cu", "none: XLA's fusions in hybridgl_tpu/models/sam/image_encoder.py")
       for name in SAM_GLUE},
}
# the glue's operands: x and the GEMM outputs (esize each), the LayerNorm params (pe), the
# bias of width D (or F, 3D); (reads, writes) of [T, D] rows, and the ops a value
_GLUE_ROWS = {"layer_norm": (1, 1, 8), "residual_add": (2, 1, 2), "residual_layer_norm": (2, 2, 10),
              "inject_layer_norm": (2, 2, 12), "merge_heads": (1, 1, 0)}


# published peaks of one H100 SXM: dense bf16 on the tensor cores (the
# FLOP model's table), f32 on the CUDA cores, HBM3
PEAK_BF16_FLOPS = PEAK_FLOPS_BY_DEVICE["NVIDIA H100"]
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# kernels whose operations run in f32 on the CUDA cores (their bound uses PEAK_F32_FLOPS)
CUDA_CORE_F32 = ("nms", "sam_qkv_heads")


def g2l_launches(vision_layers: int, masking_block: int) -> dict:
    """K6 and the fused glue of one G2L forward (:func:`clip_launches_per_image`)."""
    mb, T = masking_block, vision_layers - masking_block
    calls = mb + 2 * T
    return {"clip_attention": calls, "qkv_heads": calls, "merge_heads": calls, "bias_quick_gelu": calls,
            "layer_norm": 4, "residual_layer_norm": 2 * mb + 2 * T + (T - 1), "inject_layer_norm": T,
            "residual_add": T + 1}


def clip_launches_per_image(vision_layers: int, masking_block: int, gem_depth: int, text_layers: int) -> dict:
    """K6, GEM's attention and the CLIP block's fused glue (G1-G7) one RefCOCO
    image launches, exactly, in G2L mode: the feature graph once (the G2L
    forward, then GEM over the same tower) and the sentence graph once (the
    text tower).

    G2L (``models/clip/fusion.py:_g2l_tail``): the trunk's ``masking_block``
    blocks on the fused 2P batch and the T = depth - masking_block tail blocks
    on each of the two streams, one K6, head split, merge and QuickGELU a block
    call; LayerNorm alone for the two stems' ln_pre, block 0's ln_1 and
    ln_post; each block call's ln_2, the trunk's next ln_1 and the global
    stream's (but its last) with the residual; the injection with the local
    ln_1 (T); a residual alone at the end of each local block and the global
    last. GEM (``models/gem/gem.py``): a head split and one ``gem_attention``
    a block (the kernel writes the heads merged: no merge), ln_pre, block 0's
    ln_1 and ln_post on both streams alone, each block's ln_2 and the next
    block's ln_1 with the residual, the last block's and the ``gem_depth``
    GEM-stream residuals alone, a QuickGELU a block. The text tower (plain
    attention): block 0's ln_1 alone, each block's ln_2 and next ln_1
    (ln_final after the last) with the residual, a QuickGELU a block."""
    g2l = g2l_launches(vision_layers, masking_block)
    gem = {"gem_attention": vision_layers, "qkv_heads": vision_layers, "layer_norm": 4,
           "residual_layer_norm": 2 * vision_layers - 1, "residual_add": gem_depth + 1,
           "bias_quick_gelu": vision_layers}
    text = {"layer_norm": 1, "residual_layer_norm": 2 * text_layers, "bias_quick_gelu": text_layers}
    return {k: g2l.get(k, 0) + gem.get(k, 0) + text.get(k, 0) for k in {**g2l, **gem}}


def kernel_work(name: str, **d) -> tuple[int, int]:
    """(operations, bytes) one call of kernel ``name`` needs at the shapes
    ``d``: multiply-adds count 2, every input byte is read once and every
    output byte written once. Where the work depends on the data (the
    placement window of the pass-1 stats) it is what these inputs need.

    Shapes: the attention kernels take BH, S, hd, esize (bytes per q/k/v
    element) and G (rel-pos) or N (CLS-row bias rows); GEM's attention also
    ``ensemble`` and ``iters`` (the trunk's attention, and with the ensemble
    three more an iteration; q, k, v in, one or two outputs); the pass-1 stats B, n,
    C, dh, dw (window extent), esize (stats dtype) and, full mode, n2; the
    decoder kernels B, S, C, Cq, GT, shared (qside and base are [1, S, .]);
    K4 B, S, C, c4, c8, m; the NMS kernel N and read_words, the mask words its
    sweep read for these boxes (the diagonal words and the kept rows' words
    right of theirs)."""
    if name in ("flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos"):
        BH, S, hd, G, e = d["BH"], d["S"], d["hd"], d["G"], d["esize"]
        return 4 * BH * S * S * hd, 4 * BH * S * hd * e + 2 * BH * S * G * 4
    if name == "clip_attention":
        BH, S, hd, N, e = d["BH"], d["S"], d["hd"], d["N"], d["esize"]
        return 4 * BH * S * S * hd, 4 * BH * S * hd * e + N * S * 4
    if name == "gem_attention":
        BH, S, hd, e = d["BH"], d["S"], d["hd"], d["esize"]
        ens = bool(d.get("ensemble"))
        attentions = 1 + 3 * max(d.get("iters", 1), 1) * ens
        return 4 * BH * S * S * hd * attentions, (3 + 1 + ens) * BH * S * hd * e
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
    if name in _GLUE_ROWS:  # T rows of D; the LayerNorm params and the bias once; G2L's [P, L - 1] f32 masks
        T, D, e = d["T"], d["D"], d.get("esize", 2)
        reads, writes, ops = _GLUE_ROWS[name]
        small = (2 * D * d.get("pe", 2) if "layer_norm" in name else 0) + (D * e if name.startswith("residual") else 0)
        return ops * T * D, (reads + writes) * T * D * e + small + d.get("masks", 0) * 4
    if name == "qkv_heads":  # [T, 3D] in, its bias, q, k and v out
        T, D, e = d["T"], d["D"], d.get("esize", 2)
        return 3 * T * D, 2 * 3 * T * D * e + 3 * D * e
    if name == "bias_quick_gelu":  # [T, F] in and out, the bias; ~6 operations a value
        T, F, e = d["T"], d["F"], d.get("esize", 2)
        return 6 * T * F, 2 * T * F * e + F * e
    if name in ("sam_layer_norm", "sam_residual_layer_norm", "sam_residual_add"):
        # T grid rows of D in (x, and y where there is a residual), x' out; the LayerNorm's To rows out
        # (the window layout's, pad rows included) and its params (pe); the bias once
        T, D, e = d["T"], d["D"], d.get("esize", 2)
        res = name != "sam_layer_norm"
        ln_rows = d.get("To", T) if name != "sam_residual_add" else 0
        ops = T * D * (2 * res + 8 * (name != "sam_residual_add"))
        params = 2 * D * d.get("pe", 2) if ln_rows else 0
        return ops, (1 + 2 * res) * T * D * e + ln_rows * D * e + params + res * D * e
    if name == "sam_qkv_heads":  # [B, S, 3D] in, its bias; q, k, v out; the f32 tables and rel terms
        B, S, D, H, G, e = d["B"], d["S"], d["D"], d["H"], d["G"], d.get("esize", 2)
        hd = D // H
        rel = 2 * B * H * S * G  # rel_h and rel_w: a dot product of hd (hd FMAs) each
        return 3 * B * S * D + 2 * rel * hd, 2 * 3 * B * S * D * e + 3 * D * e + 2 * G * G * hd * 4 + rel * 4
    if name == "sam_merge_heads":  # [B*H, S, hd] in, [B, S, D] out
        T, D, e = d["T"], d["D"], d.get("esize", 2)
        return 0, 2 * T * D * e
    if name == "sam_bias_gelu":  # [T, F] in and out, the bias; ~10 operations a value (erf's polynomial counted as 5)
        T, F, e = d["T"], d["F"], d.get("esize", 2)
        return 10 * T * F, 2 * T * F * e + F * e
    if name == "nms":  # ~15 f32 operations an IoU of the upper triangle; boxes, valid, the mask, keep, the count
        N, W = d["N"], -(-d["N"] // 64)
        written = sum(min(64, N - 64 * rb) * (W - rb) for rb in range(W))  # the upper triangle's words
        return 15 * N * (N - 1) // 2, 16 * N + N + 8 * (written + d["read_words"]) + N + 4
    raise ValueError(f"unknown kernel {name}")


def bound_ms(operations: int, nbytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    by_ops, by_bytes = operations / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
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

    def ensemble(self, label, got, want, v, n):
        """(ok, error) of an ensemble output under :data:`ENSEMBLE_BAR`."""
        err = ensemble_score_error(got, want, v, n)
        self.verdict(label, err < ENSEMBLE_BAR,
                     f"score-dependent part: mean|d|/mean|plain| {err:.4f} (bar {ENSEMBLE_BAR})")
        return err < ENSEMBLE_BAR, err

    def record(self, name, ok, err, kernel, plain, shape, work, library=None):
        """Times the kernel, its plain version and, where there is one, the
        library call; ``work`` is :func:`kernel_work`'s shape arguments."""
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        library_ms = time_ms(library) if library is not None else None
        bound, by = bound_ms(*kernel_work(name, **work), PEAK_F32_FLOPS if name in CUDA_CORE_F32 else PEAK_BF16_FLOPS)
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
    also held on its own; then the CUDA-core kernel in f32 and at hd = 32;
    then CLIP ViT-L/14@336 at bucket 64: 128 streams x 16 heads, L = 577, bf16
    on the tensor-core kernel (one block of four warpgroups a head)."""
    from ..kernels.clip_attention import clip_attention, reference_clip_attention, variant

    for N, H, L, hd, dtype, want_kind in ((128, 12, 197, 64, torch.bfloat16, "wgmma"),
                                          (128, 12, 197, 64, torch.float32, "cuda-core"),
                                          (128, 12, 197, 32, torch.bfloat16, "cuda-core"),
                                          (128, 16, 577, 64, torch.bfloat16, "wgmma")):
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
        label = f"clip_attention ({kind}, L = {L}, hd = {hd}, {name})"
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


# the ensemble's bar on its score-dependent part (ensemble_score_error). At
# [12, 785, 64] and [16, 1025, 64], temperature hd^-0.5, bf16: the f32 output
# rounded to bf16 reads 0.054-0.055, the plain bf16 path 0.108-0.112; uniform
# scores 1.00, another stream in place of one 0.90-0.92, one stream dropped
# 0.45-0.82, the temperature halved or doubled 0.51-1.03
# (tests/test_torch_gem_attention.py holds these).
ENSEMBLE_BAR = 0.2


def ensemble_score_error(got, want, v, n: int) -> float:
    """mean|d| / mean|plain| of the part of GEM's ensemble that its scores
    decide: the output [n, L, H*hd] less its uniform part, the mean of v's
    rows over L (what every stream's softmax gives were its scores equal).
    At GEM's temperature hd^-0.5 the unit rows' scores spread by ~0.016, so
    the ensemble lies within ~2% of that uniform part, and the attention bar
    on the whole output passes a kernel with uniform scores, a stream dropped
    or another temperature; on this part they read 0.45 or more. Undefined
    at L = 1, where the output is its uniform part."""
    NH, L, hd = v.shape
    u = v.float().reshape(n, NH // n, L, hd).mean(2).reshape(n, 1, NH // n * hd)
    g, w = got.float() - u, want.float() - u
    return float((g - w).abs().mean() / (w.abs().mean() + 1e-30))


def _gem_library(q, k, v, scale, temp, ensemble):
    """GEM's attention at N = 1 from library calls (the yardstick; nothing
    in the port calls it): the trunk as one ``scaled_dot_product_attention``,
    the ensemble as one more over the three streams' unit rows (normalised in
    f32) against v, then their mean; heads merged, [E, 1, L, H*hd]."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, L, hd = q.shape
    outs = [sdpa(q[None], k[None], v[None], scale=scale)]
    if ensemble:
        unit = torch.nn.functional.normalize(torch.stack((q, k, v)).float(), dim=-1, eps=1e-6).to(q.dtype)
        outs.append(sdpa(unit, unit, v[None].expand(3, H, L, hd), scale=temp).mean(0, keepdim=True))
    return torch.stack(outs).transpose(2, 3).reshape(len(outs), 1, L, H * hd)


def _gem(run: _Run):
    """GEM's attention at GEM's two towers at N = 1 (ViT-B/16 at 448 px: 12
    heads of 785 tokens; ViT-L/14@336 at 448 px: 16 heads of 1,025), hd = 64,
    the temperature hd^-0.5 as the configuration leaves it: bf16 on the
    tensor-core kernel against the plain version on the same inputs in f32,
    timed beside the plain version in bf16 (the path the port ran before)
    and beside :func:`_gem_library`, the trunk with the ensemble (the last
    ``depth`` blocks) and the trunk alone (the others); then, untimed, two
    iterations of the ensemble in bf16 at temperature 1 and the CUDA-core
    kernel in f32. At hd^-0.5 the second pass's unit rows are alike to ~1e-4,
    so what its scores decide lies under the bf16 output's rounding (a bf16
    rounding of the f32 answer reads 8-12 on :func:`ensemble_score_error`); at
    1 it reads 0.02-0.03, and skipping the update pass 2.5-3.4. The ensemble
    is held to the attention bar and to :data:`ENSEMBLE_BAR`, and that bar
    must fail the kernel's own ensemble at uniform scores (a temperature of
    1e-6), at twice the temperature and, at two iterations, with one."""
    from ..kernels.gem_attention import gem_attention, reference_gem_attention, variant

    for H, L in ((12, 785), (16, 1025)):
        hd, scale = 64, 64**-0.5
        q, k, v = (run.randn(H, L, hd) for _ in range(3))
        for ensemble, iters, temp, dtype, timed in ((True, 1, scale, torch.bfloat16, True),
                                                    (False, 1, scale, torch.bfloat16, True),
                                                    (True, 2, 1.0, torch.bfloat16, False),
                                                    (True, 1, scale, torch.float32, False)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            kernel = lambda: gem_attention(qd, kd, vd, 1, scale, temp, iters, ensemble)  # noqa: E731
            plain = lambda: reference_gem_attention(qd, kd, vd, 1, scale, temp, iters, ensemble)  # noqa: E731
            library = lambda: _gem_library(qd, kd, vd, scale, temp, ensemble)  # noqa: E731
            got = kernel()
            want = reference_gem_attention(q.float(), k.float(), v.float(), 1, scale, temp, iters, ensemble)
            torch.cuda.synchronize()
            kind = variant(dtype, hd)
            label = (f"gem_attention ({kind}, [{H}, {L}, {hd}], {str(dtype).split('.')[-1]}, "
                     f"{f'trunk + ensemble, iters {iters}, temp {temp:g}' if ensemble else 'trunk'})")
            ok_v = run.verdict(f"{label} kernel", kind == ("wgmma" if dtype == torch.bfloat16 else "cuda-core"), kind)
            ok, err = run.attention(label, got, want)
            ok_e = True
            if ensemble:  # the ensemble on its own: the trunk's larger values would hide it in the whole
                ok_e, err_e = run.attention(f"{label} ensemble", got[1], want[1])
                ok_s, _ = run.ensemble(f"{label} ensemble", got[1], want[1], v, 1)
                ok_e, err = ok_e and ok_s, max(err, err_e)
            faults = ()  # the bar fails the kernel's own ensemble where it is wrong
            if ensemble and timed:
                faults = (("uniform scores", 1e-6, iters), ("twice the temperature", 2 * temp, iters))
            elif ensemble and iters > 1:
                faults = (("update pass skipped", temp, 1),)
            for fault, t, it in faults:
                bad = ensemble_score_error(gem_attention(qd, kd, vd, 1, scale, t, it, True)[1], want[1], v, 1)
                ok_e &= run.verdict(f"{label} ensemble bar fails a planted fault ({fault})",
                                    bad >= ENSEMBLE_BAR, f"{bad:.4f} >= {ENSEMBLE_BAR}")
            if timed:  # the library's output under the same bars: it computes the same function
                lib_ok, _ = run.attention(f"{label} library", library(), want)
                if ensemble:
                    lib_ok &= run.ensemble(f"{label} library ensemble", library()[1], want[1], v, 1)[0]
                ok_e &= lib_ok
            del got, want
            if timed:
                run.record("gem_attention", ok_v and ok and ok_e, err, kernel, plain,
                           f"[{H}, {L}, {hd}] bf16 {'trunk + ensemble' if ensemble else 'trunk'}",
                           dict(BH=H, S=L, hd=hd, esize=2, ensemble=ensemble, iters=iters), library=library)
            else:
                prev = run.results["gem_attention"]
                prev["ok"] = prev["ok"] and ok_v and ok and ok_e
                prev["max_abs_err"] = max(prev["max_abs_err"], err)
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
        window_tensor,
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
                win_d = window_tensor(win, run.dev)  # as the stage passes it: on the device, uploaded once
                kernel = lambda: pass1_stats_half(tmp, Wyd, win_d, 0.0, 1.0)  # noqa: E731
                plain = lambda: reference_pass1_stats_half(tmp, Wyd, win_d, 0.0, 1.0)  # noqa: E731
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
                win_d = window_tensor(win, run.dev)
                kernel = lambda: pass1_stats(low_d, WxT_d, Wy_d, win_d, 0.0, 1.0)  # noqa: E731
                plain = lambda: reference_pass1_stats_half(half_transform(low_d, WxT_d), Wy_d, win_d, 0.0, 1.0)  # noqa: E731
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
                pair = time_ms(lambda: pass1_stats_half(half_transform(low_d, WxT_d), Wy_d, win_d, 0.0, 1.0))
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


NMS_SIZES = (192, 1280, 3072, 12288, 1001)


def _candidate_boxes(run: _Run, N):
    """N pass-1-like candidates in a 480x640 image, integer edges as
    box_from_profiles gives them: two in three are one of N / 48 objects with
    each edge moved by up to 8 px (the many points and masks that find one
    object), the rest boxes of 8-400 px anywhere; random scores, 90% valid."""
    g, dev = run.gen, run.dev
    hi = torch.tensor([639.0, 479.0, 639.0, 479.0], device=dev)

    def anywhere(n):
        lo = torch.rand((n, 2), generator=g, device=dev) * hi[:2]
        return torch.cat([lo, lo + 8.0 + torch.rand((n, 2), generator=g, device=dev) * 392.0], 1)

    objects = anywhere(max(N // 48, 1))
    pick = torch.randint(0, objects.shape[0], (N,), generator=g, device=dev)
    jitter = torch.randint(-8, 9, (N, 4), generator=g, device=dev).float()
    boxes = torch.where(torch.rand((N, 1), generator=g, device=dev) < 2 / 3, objects[pick] + jitter, anywhere(N))
    boxes = torch.minimum(boxes.floor().clamp(min=0.0), hi).contiguous()
    return boxes, torch.rand(N, generator=g, device=dev), torch.rand(N, generator=g, device=dev) > 0.1


def _parent_route(boxes, scores, thr, valid):
    """The port's NMS before its kernel, for its time only: the f32 IoU matrix
    on the card, downloaded, and the sweep in a host loop."""
    import numpy as np

    from ..kernels.masks import box_iou_matrix

    order = torch.sort(-torch.where(valid, scores, -1e30), stable=True).indices
    b = boxes[order]
    iou = box_iou_matrix(b, b).cpu().numpy()
    idx, suppressed = np.arange(len(iou)), np.zeros(len(iou), bool)
    for i in range(len(iou)):
        if not suppressed[i]:
            suppressed |= (iou[i] > thr) & (idx > i)
    return int((~suppressed & valid[order].cpu().numpy()).sum())


def _nms(run: _Run):
    """The port's NMS kernel at the proposal stage's N (RefCOCO 192; PhraseCut
    3,072 a layer-1 crop, 12,288 the full-image crop, 1,280 across crops) and
    at a ragged N, box_nms_thresh 0.7: the wrapper's order, keep_sorted and
    num_kept exactly equal to the plain version's (the score sort, then
    reference_nms_sorted). Times: the operator (both kernels), its plain
    version (the bitmask on the card, downloaded, the sweep on the host), the
    whole wrapper (with its sort; it reads nothing back), the parent's route (the f32
    IoU matrix downloaded)."""
    from ..kernels.nms import _n1, nms, reference_nms_sorted, suppression_matrix, sweep

    thr = 0.7
    for N in NMS_SIZES:
        boxes, scores, valid = _candidate_boxes(run, N)
        got = nms(boxes, scores, thr, valid)
        order = torch.sort(-torch.where(valid, scores, -1e30), stable=True).indices
        b, v = boxes[order].contiguous(), valid[order].contiguous()
        keep, num = reference_nms_sorted(b, v, thr)
        torch.cuda.synchronize()
        d_keep = int((got.keep_sorted != keep).sum())
        kept = int(got.num_kept)
        ok = torch.equal(got.order, order) and d_keep == 0 and kept == int(num)
        run.verdict(f"nms N = {N}", ok, f"order equal {torch.equal(got.order, order)}, keep_sorted flags differing "
                    f"{d_keep}, num_kept {kept} (plain {int(num)}) of {int(valid.sum())} valid")
        kept_rows = (~sweep(suppression_matrix(b, thr).cpu())).nonzero().flatten()
        W = -(-N // 64)
        read_words = N + int((W - kept_rows // 64 - 1).sum())
        wrapper_ms = time_ms(lambda: nms(boxes, scores, thr, valid))
        parent_ms = time_ms(lambda: _parent_route(boxes, scores, thr, valid))
        run.log(f"  nms N = {N}: the wrapper (sort, gather, operator) {wrapper_ms:.3f} ms, the parent's "
                f"route (f32 IoU matrix downloaded, host sweep) {parent_ms:.3f} ms, kept {kept}")
        run.record("nms", ok, float(max(d_keep > 0, abs(kept - int(num)))), lambda: _n1(b, v, thr),
                   lambda: reference_nms_sorted(b, v, thr), f"N = {N}, threshold {thr}",
                   dict(N=N, read_words=read_words))
        torch.cuda.empty_cache()


def glue_matches(name: str, got, want) -> bool:
    """The fused glue's bar against its plain version: equal bit for bit,
    except a LayerNorm's output (summed in a warp's order, not PyTorch's),
    which lies within one rounding step of the plain output in bf16 (the
    step at the larger of the two magnitudes, at least 2^-8's) and within
    1e-5 + 1e-5 |plain| in f32."""
    if "layer_norm" not in name or got.dtype not in (torch.bfloat16, torch.float32):
        return got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if got.dtype == torch.float32:
        return got.shape == want.shape and bool((d <= 1e-5 + 1e-5 * w.abs()).all())
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp(min=2.0**-8))) - 7)
    return got.shape == want.shape and bool((d <= step).all())


def _glue_cases(run: _Run, streams: int, L: int, D: int, H: int):
    """(name, kernel, plain, kernel_work arguments, library) of each glue
    operator on ``streams`` rows of L tokens of width D, bf16 with bf16
    LayerNorm params as the main path runs it; the LayerNorm also on the
    streams' CLS rows (a strided view, as ln_post reads them)."""
    from ..kernels import clip_glue as cg

    r = lambda *shape, std=1.0: run.randn(*shape, std=std)  # noqa: E731
    T = streams * L
    x, y, x2 = r(streams, L, D), r(streams, L, D, std=2.0), r(streams, L, D)
    b, scale, bias = r(D, std=0.5), (1.0 + r(D, std=0.1).float()).to(torch.bfloat16), r(D, std=0.1)
    m = torch.rand((streams, L - 1), generator=run.gen, device=run.dev)
    m[m < 0.4] = 0.0
    qkv, b3 = r(streams, L, 3 * D), r(3 * D, std=0.5)
    ctx = r(streams * H, L, D // H)
    h, b4 = r(streams, L, 4 * D, std=3.0), r(4 * D, std=0.5)
    cls = x[:, 0, :]
    rows = dict(T=T, D=D, esize=2, pe=2)
    return [
        ("layer_norm", lambda: cg.layer_norm(x, scale, bias), lambda: cg.reference_layer_norm(x, scale, bias), rows,
         lambda: torch.nn.functional.layer_norm(x, (D,), scale, bias, 1e-5)),
        ("residual_add", lambda: cg.residual_add(x, y, b), lambda: cg.reference_residual_add(x, y, b), rows, None),
        ("residual_layer_norm", lambda: cg.residual_layer_norm(x, y, b, scale, bias),
         lambda: cg.reference_residual_layer_norm(x, y, b, scale, bias), rows, None),
        ("inject_layer_norm", lambda: cg.inject_layer_norm(x, x2, m, scale, bias),
         lambda: cg.reference_inject_layer_norm(x, x2, m, scale, bias), dict(rows, masks=m.numel()), None),
        ("qkv_heads", lambda: cg.qkv_heads(qkv, b3, H), lambda: cg.reference_qkv_heads(qkv, b3, H),
         dict(T=T, D=D, esize=2), None),
        ("merge_heads", lambda: cg.merge_heads(ctx, streams), lambda: cg.reference_merge_heads(ctx, streams),
         dict(T=T, D=D, esize=2), None),
        ("bias_quick_gelu", lambda: cg.bias_quick_gelu(h, b4), lambda: cg.reference_bias_quick_gelu(h, b4),
         dict(T=T, F=4 * D, esize=2), None),
        ("layer_norm", lambda: cg.layer_norm(cls, scale, bias), lambda: cg.reference_layer_norm(cls, scale, bias),
         None, None),
    ]


def _glue(run: _Run):
    """The CLIP block's fused glue against its plain version (bias add,
    residual, injection, head split, merge and QuickGELU equal bit for bit,
    LayerNorm within one rounding step: :func:`glue_matches`), timed at
    ViT-B/16's trunk at proposal buckets 32 and 64 (64 and 128 streams of
    197 tokens, D = 768, 12 heads, MLP 3072), and checked untimed at the
    other rows the main path gives it: the trunk at bucket 8 (ln_post on 8
    CLS rows), GEM's 785 tokens and the text tower's 77-token rows of 512
    (8 heads, MLP 2048; 16 sentence streams). The library yardstick of the
    LayerNorm is one ``F.layer_norm``."""
    shapes = [(64, 197, 768, 12, "bucket 32", True), (128, 197, 768, 12, "bucket 64", True),
              (8, 197, 768, 12, "bucket 8", False), (1, 785, 768, 12, "GEM", False),
              (16, 77, 512, 8, "text tower", False)]
    for streams, L, D, H, tag, timed in shapes:
        for name, kernel, plain, work, library in _glue_cases(run, streams, L, D, H):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got, want = ([t] if isinstance(t, torch.Tensor) else list(t) for t in (got, want))
            ok = all(glue_matches(name, g, w) for g, w in zip(got, want, strict=True))
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            moved = sum(int((g != w).sum()) for g, w in zip(got, want))
            label = f"{name} (T = {streams * L} of {D}, {tag}{'' if work else ', CLS rows'})"
            run.verdict(label, ok, f"outputs that differ {moved} of {sum(g.numel() for g in got)}, max|d| {err:.3e}")
            if timed and work is not None:
                run.record(name, ok, err, kernel, plain, f"[{streams}, {L}, {D}] bf16", work, library=library)
            else:
                run.results[name]["ok"] = run.results[name]["ok"] and ok
                run.results[name]["max_abs_err"] = max(run.results[name]["max_abs_err"], err)
        torch.cuda.empty_cache()


def sam_glue_matches(name: str, index: int, got, want) -> bool:
    """The SAM glue's bar against its plain version: equal bit for bit, except
    a LayerNorm's output (:func:`glue_matches`; the second of
    ``sam_residual_layer_norm``'s) and the qkv kernel's f32 rel-pos terms
    (its fourth and fifth), dot products summed in another order: within
    1e-5 of the largest plain term and 1e-5 relative."""
    if name == "sam_layer_norm" or (name == "sam_residual_layer_norm" and index == 1):
        return glue_matches("layer_norm", got, want)
    if name == "sam_qkv_heads" and index >= 3:
        g, w = got.float(), want.float()
        bar = 1e-5 * float(w.abs().max()) + 1e-5 * w.abs()
        return got.dtype == want.dtype and got.shape == want.shape and bool(((g - w).abs() <= bar).all())
    return got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


def _sam_glue_cases(run: _Run, N: int, D: int = 1280, H: int = 16, win: int = 14, grid: int = 64):
    """(name, label, kernel, plain, kernel_work arguments, library) of each SAM
    glue operator at a ViT encoder's geometry over N images: the windowed
    block (N * 25 windows of 196 tokens from the 64 -> 70 pad) and the global
    block (the 64 x 64 grid), bf16 with bf16 LayerNorm params as the main
    path runs them."""
    from ..kernels import sam_glue as sg

    r = lambda *shape, std=1.0: run.randn(*shape, std=std)  # noqa: E731
    hd, T = D // H, N * grid * grid
    nw = (-(-grid // win)) ** 2
    B, S, To = N * nw, win * win, N * nw * win * win
    x = r(N, grid, grid, D)
    b, b3, b4 = r(D, std=0.5), r(3 * D, std=0.5), r(4 * D, std=0.5)
    scale, bias = (1.0 + r(D, std=0.1).float()).to(torch.bfloat16), r(D, std=0.1)
    tabs = {G: [torch.randn((G, G, hd), generator=run.gen, device=run.dev) * 0.2 for _ in range(2)]
            for G in (win, grid)}
    y_win, y_grid, m = r(B, S, D, std=2.0), r(N, grid * grid, D, std=2.0), r(N, grid, grid, D, std=2.0)
    qkv_win, qkv_grid = r(B, S, 3 * D), r(N, grid * grid, 3 * D)
    ctx_win, ctx_grid = r(B * H, S, hd), r(N * H, grid * grid, hd)
    h = r(N, grid, grid, 4 * D, std=3.0)
    rows = dict(T=T, D=D, esize=2, pe=2)
    return [
        ("sam_layer_norm", "ln_1 into 14 x 14 windows", lambda: sg.layer_norm(x, scale, bias, win),
         lambda: sg.reference_layer_norm(x, scale, bias, win), dict(rows, To=To),
         lambda: torch.nn.functional.layer_norm(x, (D,), scale, bias, 1e-6)),
        ("sam_layer_norm", "ln_1 on the grid", lambda: sg.layer_norm(x, scale, bias, 0),
         lambda: sg.reference_layer_norm(x, scale, bias, 0), None, None),
        ("sam_qkv_heads", f"{B} windows of {S}", lambda: sg.qkv_heads(qkv_win, b3, *tabs[win], H),
         lambda: sg.reference_qkv_heads(qkv_win, b3, *tabs[win], H), dict(B=B, S=S, D=D, H=H, G=win), None),
        ("sam_qkv_heads", f"the {grid} x {grid} grid", lambda: sg.qkv_heads(qkv_grid, b3, *tabs[grid], H),
         lambda: sg.reference_qkv_heads(qkv_grid, b3, *tabs[grid], H),
         dict(B=N, S=grid * grid, D=D, H=H, G=grid), None),
        ("sam_merge_heads", f"{B} windows", lambda: sg.merge_heads(ctx_win, B),
         lambda: sg.reference_merge_heads(ctx_win, B), dict(T=B * S, D=D), None),
        ("sam_merge_heads", "the grid", lambda: sg.merge_heads(ctx_grid, N),
         lambda: sg.reference_merge_heads(ctx_grid, N), dict(T=T, D=D), None),
        ("sam_residual_layer_norm", "out-projection from windows + ln_2",
         lambda: sg.residual_layer_norm(x, y_win, b, scale, bias, win, 0),
         lambda: sg.reference_residual_layer_norm(x, y_win, b, scale, bias, win, 0), rows, None),
        ("sam_residual_layer_norm", "MLP + the next ln_1 into windows",
         lambda: sg.residual_layer_norm(x, m, b, scale, bias, 0, win),
         lambda: sg.reference_residual_layer_norm(x, m, b, scale, bias, 0, win), dict(rows, To=To), None),
        ("sam_residual_layer_norm", "global out-projection + ln_2",
         lambda: sg.residual_layer_norm(x, y_grid, b, scale, bias, 0, 0),
         lambda: sg.reference_residual_layer_norm(x, y_grid, b, scale, bias, 0, 0), None, None),
        ("sam_residual_add", "the last block's MLP", lambda: sg.residual_add(x, m, b),
         lambda: sg.reference_residual_add(x, m, b), rows, None),
        ("sam_bias_gelu", f"[{T}, {4 * D}]", lambda: sg.bias_gelu(h, b4), lambda: sg.reference_bias_gelu(h, b4),
         dict(T=T, F=4 * D), lambda: torch.nn.functional.gelu(h)),
    ]


def _sam_glue(run: _Run):
    """The SAM encoder block's fused glue against its plain version (bias
    adds, residuals, window partition and unpartition, head split, merge and
    GELU equal bit for bit, LayerNorm within one rounding step, the rel-pos
    terms within f32 rounding: :func:`sam_glue_matches`), timed at ViT-H's
    blocks over one image and checked untimed over five (PhraseCut's crop
    batch). The library yardsticks: one ``F.layer_norm`` (no partition), one
    ``F.gelu`` (no bias)."""
    for N, timed in ((1, True), (5, False)):
        for name, label, kernel, plain, work, library in _sam_glue_cases(run, N):
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got, want = ([t] if isinstance(t, torch.Tensor) else list(t) for t in (got, want))
            ok = all(sam_glue_matches(name, i, g, w) for i, (g, w) in enumerate(zip(got, want, strict=True)))
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            moved = sum(int((g != w).sum()) for g, w in zip(got, want))
            run.verdict(f"{name} ({label}, {N} image{'s' * (N > 1)})", ok,
                        f"outputs that differ {moved} of {sum(g.numel() for g in got)}, max|d| {err:.3e}")
            if timed and work is not None:
                run.record(name, ok, err, kernel, plain, label, work, library=library)
            else:
                run.results[name]["ok"] = run.results[name]["ok"] and ok
                run.results[name]["max_abs_err"] = max(run.results[name]["max_abs_err"], err)
            del got, want
        torch.cuda.empty_cache()


# what run_checks reports for each kernel (library_ms is None where no
# PyTorch call computes the kernel's function; GEM's is two and their glue)
RESULT_KEYS = ("ok", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

# each group checks the kernels it names
_GROUPS = (
    (("flash_windowed_fused", "flash_attention_fused", "flash_attention_rel_pos"), _rel_pos),
    (("clip_attention",), _clip),
    (("pass1_stats_half", "pass1_stats"), _pass1),
    (("i2t_ln_then_t2i", "i2t_ln_update", "t2i_ctx", "upscale_hyper_blocked"), _decoder),
    (("nms",), _nms),
    (("gem_attention",), _gem),
    (GLUE, _glue),
    (SAM_GLUE, _sam_glue),
)


def run_checks(names=None, log=print) -> dict:
    """Check the named kernels (default: all twenty-five) on the card.

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
