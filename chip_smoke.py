"""On-card smoke test of the PyTorch/CUDA port (hybridgl_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (every phase asserts; any failure exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
  2. build: compiles the port's CUDA kernels from csrc/ (one nvcc per
     source, all at once, sm_90a);
  3. kernels: each of the eight CUDA kernels against its plain PyTorch
     version at the main paths' shapes, bf16 inputs, TF32 off, with median
     times;
  4. small-input parity: the port on the card against the port on the CPU
     (the kernels' plain versions) at two small f32 configurations, single
     crop (K1, K2, K5, K6 and the default decoder route, K3 + K4) and
     multicrop (pass 2 through K7 + K8): same proposals and selections;
  5. RefCOCO pipeline: HybridGLPipeline.run_image at full width (SAM ViT-H +
     CLIP ViT-B/16, random bf16 weights from seed 0, AMG at RefCOCO
     settings with the quality thresholds zeroed as the reference bench
     does) on one warm-up and three measured synthetic images, checking
     finite outputs and that every kernel of the path launched;
  6. PhraseCut pipeline: the same at AMG_PHRASECUT (pps 64, one crop layer,
     P = 128, canonical 1024), one warm-up and two measured images.
The decoder runs its default route: the HYBRIDGL_FUSED_* switches are
removed from the environment at start. The second-to-last line is a JSON
object with one entry per kernel; the last line is the JSON contract line.
``--profile`` adds a breakdown of one more RefCOCO image (stage wall times,
device time by kernel from torch.profiler), the scoring stages on a full
bucket of 64 synthetic proposals, the RefCOCO ms/img with the four decoder
switches at 0 beside the default route, the decoder chunk times, and the
multicrop stage times.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
DECODER_SWITCHES = tuple(f"HYBRIDGL_FUSED_{k}" for k in ("PASS", "I2T", "T2I", "UPSCALE"))
for _k in DECODER_SWITCHES:  # the contract run takes the default decoder route
    os.environ.pop(_k, None)

KERNELS = {
    "flash_windowed_fused": (
        "hybridgl_tpu_torch/csrc/attention.cu",
        "hybridgl_tpu/kernels/flash_attention.py:276",
    ),
    "flash_attention_fused": (
        "hybridgl_tpu_torch/csrc/attention.cu",
        "hybridgl_tpu/kernels/flash_attention.py:171",
    ),
    "pass1_stats_half": (
        "hybridgl_tpu_torch/csrc/pass1_stats.cu",
        "hybridgl_tpu/kernels/pass1_stats.py:257",
    ),
    "clip_attention": (
        "hybridgl_tpu_torch/csrc/attention.cu",
        "hybridgl_tpu/kernels/clip_attention.py:78",
    ),
    "i2t_ln_then_t2i": (
        "hybridgl_tpu_torch/csrc/decoder_attn.cu",
        "hybridgl_tpu/kernels/decoder_pass.py:209",
    ),
    "upscale_hyper_blocked": (
        "hybridgl_tpu_torch/csrc/upscale_hyper.cu",
        "hybridgl_tpu/kernels/upscale_hyper.py:153",
    ),
    "i2t_ln_update": (
        "hybridgl_tpu_torch/csrc/decoder_attn.cu",
        "hybridgl_tpu/kernels/decoder_attn.py:95",
    ),
    "t2i_ctx": (
        "hybridgl_tpu_torch/csrc/decoder_attn.cu",
        "hybridgl_tpu/kernels/decoder_attn_t2i.py:82",
    ),
}
# per-image launches on the RefCOCO path (one launch per call): 28 windowed
# and 4 global SAM blocks, one pass-1 chunk of 64 points (two K3 layer
# passes, one K4 tail), 9 trunk + 3 x 2 G2L stream CLIP blocks
MIN_LAUNCHES_PER_IMAGE = {
    "flash_windowed_fused": 28,
    "flash_attention_fused": 4,
    "pass1_stats_half": 1,
    "clip_attention": 15,
    "i2t_ln_then_t2i": 2,
    "upscale_hyper_blocked": 1,
}
# the PhraseCut path adds the pass-2 re-decode on the per-prompt route: two
# K7 image->token updates and three K8 token->image attentions; its five
# encoder passes and 128 pass-1 chunks launch the others many times over
MIN_LAUNCHES_PER_PHRASECUT_IMAGE = dict(MIN_LAUNCHES_PER_IMAGE, i2t_ln_update=2, t2i_ctx=3)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    log(f"card: {smi[0] if smi else 'nvidia-smi unavailable'}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from hybridgl_tpu_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi[0] if smi else ""


def phase_build():
    from hybridgl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_seconds} s in nvcc) -> {_build.build()}")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


def _attention_verdict(name, got, want):
    g, w = got.float().flatten(), want.float().flatten()
    if not bool(g.isfinite().all()):
        fail(f"{name}: non-finite kernel output")
    cos = float((g @ w) / (g.norm() * w.norm() + 1e-30))
    d = (g - w).abs()
    rel = float(d.mean() / (w.abs().mean() + 1e-30))
    ok = cos >= 0.999 and rel < 0.02
    log(f"{'PASS' if ok else 'FAIL'} {name}: cos {cos:.6f} mean|d|/mean|plain| {rel:.5f} max|d| {float(d.max()):.5f}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return float(d.max())


def phase_kernels():
    import torch

    from hybridgl_tpu_torch.kernels.clip_attention import clip_attention, reference_clip_attention
    from hybridgl_tpu_torch.kernels.flash_attention import (
        flash_attention_fused,
        flash_windowed_fused,
        reference_attention_rel_pos,
    )
    from hybridgl_tpu_torch.kernels.masks import box_from_profiles
    from hybridgl_tpu_torch.kernels.pass1_stats import (
        half_transform,
        pass1_stats_half,
        reference_pass1_stats_half,
    )
    from hybridgl_tpu_torch.kernels.resize import _composed_axis_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results = {}

    # K1 / K2: ViT-H windowed (25 windows x 16 heads, S = 196, G = 14) and
    # global (16 heads, S = 4096, G = 64) blocks, hd = 80, nonzero rel terms
    for name, fn, BH, G in (
        ("flash_windowed_fused", flash_windowed_fused, 25 * 16, 14),
        ("flash_attention_fused", flash_attention_fused, 16, 64),
    ):
        S, hd = G * G, 80
        q, k, v = randn(BH, S, hd), randn(BH, S, hd), randn(BH, S, hd)
        rh = randn(BH, S, G, std=0.5, dtype=torch.float32)
        rw = randn(BH, S, G, std=0.5, dtype=torch.float32)
        scale = hd**-0.5
        got = fn(q, k, v, rh, rw, G, scale)
        want = reference_attention_rel_pos(q, k, v, rh, rw, G, scale)
        torch.cuda.synchronize()
        err = _attention_verdict(name, got, want)
        ms = time_ms(lambda: fn(q, k, v, rh, rw, G, scale))
        plain_ms = time_ms(lambda: reference_attention_rel_pos(q, k, v, rh, rw, G, scale))
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log(f"  {name} [{BH}, {S}, {hd}] bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        del q, k, v, rh, rw, got, want

    # K6: 2P = 128 crop streams x 12 heads, L = 197, hd = 64; the CLS-row
    # bias masks about half the patches with finfo(float32).min
    N, H, L, hd = 128, 12, 197, 64
    q, k, v = randn(N * H, L, hd), randn(N * H, L, hd), randn(N * H, L, hd)
    allowed = torch.rand((N, L), generator=gen, device=dev) > 0.5
    allowed[:, 0] = True
    cls_bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min).float().contiguous()
    scale = hd**-0.5
    got = clip_attention(q, k, v, cls_bias, H, scale)
    want = reference_clip_attention(q, k, v, cls_bias, H, scale)
    torch.cuda.synchronize()
    err = _attention_verdict("clip_attention", got, want)
    ms = time_ms(lambda: clip_attention(q, k, v, cls_bias, H, scale))
    plain_ms = time_ms(lambda: reference_clip_attention(q, k, v, cls_bias, H, scale))
    results["clip_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(f"  clip_attention [{N * H}, {L}, {hd}] bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    del q, k, v, got, want

    # K5: 64 points x 3 masks of 256^2 logits placed into the 640 canonical
    # frame of a 480x640 image (rh, rw = 768, 1024 in SAM's 1024 frame)
    Bc, n, C, h, w, rh_, rw_ = 192, 256, 640, 480, 640, 768, 1024
    coarse = torch.randn((Bc, 1, 12, 12), generator=gen, device=dev) * 4.0
    low = torch.nn.functional.interpolate(coarse, size=(n, n), mode="bilinear")[:, 0]
    low = low + torch.randn((Bc, n, n), generator=gen, device=dev) * 0.1
    Wy = _composed_axis_weights(C, n, 1024, rh_, 0, h, dev)
    Wx = _composed_axis_weights(C, n, 1024, rw_, 0, w, dev)
    tmp = half_transform(low, Wx.T)
    window = (0, 0, h, w)
    stab, ra, ca = pass1_stats_half(tmp, Wy, window, 0.0, 1.0)
    stab0, ra0, ca0 = reference_pass1_stats_half(tmp, Wy.to(tmp.dtype), window, 0.0, 1.0)
    torch.cuda.synchronize()
    ds = float((stab - stab0).abs().max())
    db = float((box_from_profiles(ra, ca) - box_from_profiles(ra0, ca0)).abs().max())
    ok = ds <= 1e-3 and db <= 1.0 and bool(torch.isfinite(stab).all())
    log(f"{'PASS' if ok else 'FAIL'} pass1_stats_half: stability max|d| {ds:.6f} box edge max|d| {db:.1f} px")
    if not ok:
        fail("pass1_stats_half disagrees with its plain version")
    Wyb = Wy.to(tmp.dtype)
    ms = time_ms(lambda: pass1_stats_half(tmp, Wyb, window, 0.0, 1.0))
    plain_ms = time_ms(lambda: reference_pass1_stats_half(tmp, Wyb, window, 0.0, 1.0))
    results["pass1_stats_half"] = dict(max_abs_err=ds, ms=ms, plain_ms=plain_ms)
    log(f"  pass1_stats_half [{Bc}, {n}, {C}] bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # K5 at PhraseCut: canonical 1024 and the window of a layer-1 crop of a
    # 480x640 image (origin (159, 239), 321x401, SAM frame 820x1024)
    C, window = 1024, (159, 239, 321, 401)
    Wy = _composed_axis_weights(C, n, 1024, 820, window[0], window[2], dev)
    Wx = _composed_axis_weights(C, n, 1024, 1024, window[1], window[3], dev)
    tmp = half_transform(low, Wx.T)
    stab, ra, ca = pass1_stats_half(tmp, Wy, window, 0.0, 1.0)
    stab0, ra0, ca0 = reference_pass1_stats_half(tmp, Wy.to(tmp.dtype), window, 0.0, 1.0)
    torch.cuda.synchronize()
    ds = float((stab - stab0).abs().max())
    db = float((box_from_profiles(ra, ca) - box_from_profiles(ra0, ca0)).abs().max())
    ok = ds <= 1e-3 and db <= 1.0 and bool(torch.isfinite(stab).all()) and bool(ra.any())
    log(f"{'PASS' if ok else 'FAIL'} pass1_stats_half (crop window {window}, C = {C}): stability max|d| {ds:.6f} "
        f"box edge max|d| {db:.1f} px")
    if not ok:
        fail("pass1_stats_half disagrees with its plain version on a crop window")
    Wyb = Wy.to(tmp.dtype)
    ms = time_ms(lambda: pass1_stats_half(tmp, Wyb, window, 0.0, 1.0))
    plain_ms = time_ms(lambda: reference_pass1_stats_half(tmp, Wyb, window, 0.0, 1.0))
    log(f"  pass1_stats_half [{Bc}, {n}, {C}] crop window bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    del low, tmp, coarse
    results.update(phase_decoder_kernels(dev, gen))
    return results


def _i2t_ops(dev, gen, B, Cq, C=256, heads=8, tp=8, T=7):
    """Token-side operands of K3/K7 at SAM's decoder widths: w [B, Cq, 64]
    f32, off (-1e30 on the padding lane t = 7), vo [B, 64, C] bf16, const/LN."""
    import torch

    def r(*shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    off = r(B, heads, tp, std=0.5)
    off[:, :, T:] = -1e30
    return dict(w=r(B, Cq, heads * tp, std=Cq**-0.5 * 2), off=off.reshape(B, -1),
                vo=r(B, heads * tp, C, std=0.5).to(torch.bfloat16), const=r(C, std=0.1),
                ln_scale=1.0 + r(C, std=0.1), ln_bias=r(C, std=0.1))


def phase_decoder_kernels(dev, gen):
    """K3, K7, K8 and K4 against their plain versions at full width: C = 256,
    8 heads, tp = 8 (GT = 64), S = 4096; B = 64 (a pass-1 chunk) for K3/K4,
    B = 128 (PhraseCut's pass 2) for K7/K8."""
    import torch

    from hybridgl_tpu_torch.kernels.decoder_attn import i2t_ln_update, reference_i2t_ln_update
    from hybridgl_tpu_torch.kernels.decoder_attn_t2i import reference_t2i_ctx, t2i_ctx
    from hybridgl_tpu_torch.kernels.decoder_pass import i2t_ln_then_t2i, reference_i2t_ln_then_t2i
    from hybridgl_tpu_torch.kernels.upscale_hyper import reference_upscale_hyper, upscale_hyper

    bf, S, C = torch.bfloat16, 4096, 256

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    results = {}
    # K3: pass A (shared once-projected queries [1, S, 128], raw image and pe
    # [1, S, 256]) and pass B (per-prompt keys [64, S, 256])
    B = 64
    pe = randn(1, S, C)
    k3 = {}
    for mode, shared in (("pass A", True), ("pass B", False)):
        Cq = 128 if shared else C
        ops = _i2t_ops(dev, gen, B, Cq)
        qside = randn(1 if shared else B, S, Cq)
        base = randn(1, S, C) if shared else qside
        qw = randn(B, C, 64, std=C**-0.5 * 2, dtype=torch.float32)

        def run(fn):
            return fn(qside, base, pe, **ops, qw_next=qw, heads=8, tp=8, shared_qside=shared)

        (keys, ctx), (keys0, ctx0) = run(i2t_ln_then_t2i), run(reference_i2t_ln_then_t2i)
        torch.cuda.synchronize()
        err = max(_attention_verdict(f"i2t_ln_then_t2i {mode} keys'", keys, keys0),
                  _attention_verdict(f"i2t_ln_then_t2i {mode} ctx", ctx, ctx0))
        ms, plain_ms = time_ms(lambda: run(i2t_ln_then_t2i)), time_ms(lambda: run(reference_i2t_ln_then_t2i))
        log(f"  i2t_ln_then_t2i {mode} B = {B}, qside [{qside.shape[0]}, {S}, {Cq}] bf16: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        k3[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del keys, ctx, keys0, ctx0, qside, base
    # the JSON line carries pass B, the per-prompt stream; pass A is logged
    results["i2t_ln_then_t2i"] = dict(k3["pass B"], max_abs_err=max(v["max_abs_err"] for v in k3.values()))

    # K7 and K8 at PhraseCut's pass 2: P = 128 survivors, per-prompt keys
    B = 128
    keys = randn(B, S, C)
    ops = _i2t_ops(dev, gen, B, C)
    got = i2t_ln_update(keys, keys, **ops, heads=8, tp=8, pe=pe)
    want = reference_i2t_ln_update(keys, keys, **ops, heads=8, tp=8, pe=pe)
    torch.cuda.synchronize()
    err = _attention_verdict("i2t_ln_update", got, want)
    del got, want
    ms = time_ms(lambda: i2t_ln_update(keys, keys, **ops, heads=8, tp=8, pe=pe))
    plain_ms = time_ms(lambda: reference_i2t_ln_update(keys, keys, **ops, heads=8, tp=8, pe=pe))
    results["i2t_ln_update"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(f"  i2t_ln_update B = {B}, keys [{B}, {S}, {C}] + pe bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    qw = randn(B, C, 64, std=C**-0.5 * 2, dtype=torch.float32)
    qw[:, :, 7::8] = 0.0  # padding columns
    got, want = t2i_ctx(keys, pe, qw), reference_t2i_ctx(keys, pe, qw)
    torch.cuda.synchronize()
    err = _attention_verdict("t2i_ctx", got, want)
    ms, plain_ms = time_ms(lambda: t2i_ctx(keys, pe, qw)), time_ms(lambda: reference_t2i_ctx(keys, pe, qw))
    results["t2i_ctx"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    log(f"  t2i_ctx B = {B}, keys [{B}, {S}, {C}] bf16 -> [{B}, 64, {C}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    del keys

    # K4: a pass-1 chunk's tail, B = 64, g = 64, c4 = 64, c8 = 32, m = 3
    B = 64
    args = (randn(B, S, C), randn(C, 256, std=C**-0.5, dtype=torch.float32), randn(64, std=0.1, dtype=torch.float32),
            1.0 + randn(64, std=0.1, dtype=torch.float32), randn(64, std=0.1, dtype=torch.float32),
            randn(64, 128, std=64**-0.5, dtype=torch.float32), randn(32, std=0.1, dtype=torch.float32),
            randn(B, 3, 32, std=0.5))
    got, want = upscale_hyper(*args), reference_upscale_hyper(*args)
    torch.cuda.synchronize()
    d = float((got - want).abs().max())
    agree = float(((got > 0) == (want > 0)).float().mean())
    ok = bool(torch.isfinite(got).all()) and d < 0.1 and agree > 0.995
    log(f"{'PASS' if ok else 'FAIL'} upscale_hyper_blocked: logits max|d| {d:.5f}, sign agreement {agree:.6f}")
    if not ok:
        fail("upscale_hyper_blocked disagrees with its plain version")
    del got, want
    ms, plain_ms = time_ms(lambda: upscale_hyper(*args)), time_ms(lambda: reference_upscale_hyper(*args))
    results["upscale_hyper_blocked"] = dict(max_abs_err=d, ms=ms, plain_ms=plain_ms)
    log(f"  upscale_hyper_blocked src [{B}, {S}, {C}] bf16 -> [{B}, 3, 256, 256] f32: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return results


SENTENCES = ["the large brown dog on the left", "person behind the table"]


def _tokenizer():
    from hybridgl_tpu.models.clip.tokenizer import default_tokenizer

    return default_tokenizer()


class _TinyVocabTokenizer:
    """Deterministic word ids inside the test-tiny CLIP's 101-token vocab."""

    sot_token, eot_token = 99, 100

    def encode(self, text):
        return [sum(map(ord, w)) % 97 + 1 for w in text.split()][:40]


def _sample(rng, sam_size, canonical, h, w, rh, rw, gt_box):
    import numpy as np

    from hybridgl_tpu_torch.pipeline.runner import ImageSample

    img1024 = np.zeros((sam_size, sam_size, 3), np.uint8)
    img1024[:rh, :rw] = rng.integers(0, 255, (rh, rw, 3), np.uint8)
    imgc = np.zeros((canonical, canonical, 3), np.uint8)
    imgc[:h, :w] = rng.integers(0, 255, (h, w, 3), np.uint8)
    gt = np.zeros((canonical, canonical), bool)
    y0, x0, y1, x1 = gt_box
    gt[y0:y1, x0:x1] = True
    return ImageSample(img1024, rh, rw, imgc, h, w, gt, SENTENCES)


def _check_results(tag, results, props, n_sentences):
    import math

    import torch

    if len(results) != n_sentences:
        fail(f"{tag}: {len(results)} results for {n_sentences} sentences")
    P = int(props.masks.shape[0])
    for r in results:
        if not (0 <= r.pure_index < P and 0 <= r.final_index < P):
            fail(f"{tag}: selected index out of range: {r}")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in (r.pure_iou, r.final_iou)):
            fail(f"{tag}: IoU not a finite value in [0, 1]: {r}")
    for name in ("boxes_xyxy", "iou_preds", "stability", "points", "areas"):
        if not bool(torch.isfinite(getattr(props, name)).all()):
            fail(f"{tag}: non-finite proposal {name}")


def phase_small_parity():
    """The port on the card (CUDA kernels) against the port on the CPU (the
    kernels' plain versions), f32, at two small configurations: single crop,
    whose SAM grid routes through K1 (window 8) and K2 (grid 32), whose
    decoder takes the default route (K3 + K4) and whose CLIP blocks route
    through K6; and multicrop (one crop layer), whose pass 2 runs the
    decoder's per-prompt route (K7 + K8). Same proposals and the same
    selections, and every one of the eight kernels launched on the card."""
    import dataclasses

    import numpy as np
    import torch

    from hybridgl_tpu.core.config import AmgConfig, GemConfig, PipelineConfig, SamConfig, clip_preset
    from hybridgl_tpu.lang import HeuristicParser
    from hybridgl_tpu_torch.core.params import init_clip, init_sam, tree_map
    from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline

    sam_cfg = SamConfig(
        img_size=512, encoder_width=64, encoder_depth=2, encoder_heads=2, encoder_global_idx=(1,),
        window_size=8, prompt_dim=32, decoder_heads=2, decoder_mlp_dim=64, iou_head_hidden=32,
        mask_in_chans=8,
    )
    clip_cfg = clip_preset("test-tiny")
    single = AmgConfig(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
                       stability_score_thresh=0.0, min_mask_region_area=40, max_proposals=8)
    multicrop = dataclasses.replace(single, crop_n_layers=1, crop_n_points_downscale_factor=2, max_proposals=16,
                                    max_candidates_per_crop=16)
    g = torch.Generator().manual_seed(3)
    sam_p, clip_p = init_sam(g, sam_cfg), init_clip(g, clip_cfg)
    for blk in sam_p["encoder"]["blocks"]:  # nonzero rel-pos so the bias matters
        for key in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][key] = torch.randn(blk["attn"][key].shape, generator=g) * 0.2
    rng = np.random.default_rng(7)
    sample = _sample(rng, 512, 128, 96, 128, 384, 512, (20, 30, 70, 90))
    total = dict.fromkeys(KERNELS, 0)
    for tag, amg_cfg in (("single crop", single), ("multicrop", multicrop)):
        cfg = PipelineConfig(
            clip_config=clip_cfg, sam_config=sam_cfg, canonical_size=128, crop_size=clip_cfg.image_size,
            amg=amg_cfg, gem=GemConfig(img_size=32, depth=2),
        )
        cfg = cfg.replace(guidance=cfg.guidance.__class__(masking_block=1))
        out = {}
        for dev in ("cpu", "cuda"):
            move = lambda _, t: t.to(dev)  # noqa: E731
            pipe = HybridGLPipeline(cfg, tree_map(move, sam_p), tree_map(move, clip_p),
                                    HeuristicParser(), _TinyVocabTokenizer(), device=dev)
            reset_launch_counts()
            results = pipe.run_image(sample, pipe.init_state())
            props = pipe.last_proposals
            _check_results(f"small {tag}/{dev}", results, props, len(SENTENCES))
            out[dev] = (results, props, launch_counts())
        (r_cpu, p_cpu, _), (r_gpu, p_gpu, counts) = out["cpu"], out["cuda"]
        total = {k: total[k] + counts[k] for k in total}
        agree = float((p_cpu.masks == p_gpu.masks.cpu()).float().mean())
        same_valid = bool((p_cpu.valid == p_gpu.valid.cpu()).all())
        same_sel = [(a.pure_index, a.final_index) for a in r_cpu] == [(b.pure_index, b.final_index) for b in r_gpu]
        d_iou = max(abs(a.final_iou - b.final_iou) for a, b in zip(r_cpu, r_gpu))
        ok = agree >= 0.999 and same_valid and same_sel and d_iou <= 1e-4 and int(p_gpu.num) > 0
        log(f"{'PASS' if ok else 'FAIL'} small-input parity, {tag} (card vs cpu plain): proposals {p_gpu.num}, "
            f"mask agreement {agree:.6f}, same valid {same_valid}, same selections {same_sel}, "
            f"IoU max|d| {d_iou:.2e}, launches {counts}")
        if not ok:
            fail(f"small-input parity ({tag}) between the card and the CPU reference failed")
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        fail(f"small-input parity: kernels never launched on the card: {missing}")


def full_width_weights():
    """SAM ViT-H + CLIP ViT-B/16 random weights from seed 0, bf16, on the card."""
    import torch

    from hybridgl_tpu.core.config import PipelineConfig
    from hybridgl_tpu_torch.core.params import cast_tree, init_clip, init_sam, param_count

    cfg = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sam_p = cast_tree(init_sam(gen, cfg.sam), torch.bfloat16)
    clip_p = cast_tree(init_clip(gen, cfg.clip), torch.bfloat16)
    torch.cuda.synchronize()
    log(f"weights: random SAM {param_count(sam_p) / 1e6:.1f}M + CLIP {param_count(clip_p) / 1e6:.1f}M "
        f"params (bf16) in {time.perf_counter() - t0:.1f} s")
    return sam_p, clip_p


def phase_pipeline(tag, amg, canonical, n_images, min_launches, weights):
    """One main path at full width: SAM ViT-H + CLIP ViT-B/16, bf16, the
    given AMG with the quality thresholds zeroed as the reference bench does
    (random weights pass none of them), synthetic 480x640 images in the
    canonical frame; one warm-up image, then ``n_images`` measured."""
    import dataclasses

    import numpy as np
    import torch

    from hybridgl_tpu.core.config import PipelineConfig
    from hybridgl_tpu.lang import HeuristicParser
    from hybridgl_tpu_torch.kernels import launch_counts
    from hybridgl_tpu_torch.pipeline.runner import HybridGLPipeline

    cfg = PipelineConfig(sam_model="vit_h", clip_model="ViT-B/16", fusion_mode="G2L", canonical_size=canonical,
                         amg=dataclasses.replace(amg, pred_iou_thresh=0.0, stability_score_thresh=0.0))
    pipe = HybridGLPipeline(cfg, *weights, HeuristicParser(), _tokenizer(), device=torch.device("cuda"))
    rng = np.random.default_rng(0)
    samples = [_sample(rng, 1024, canonical, 480, 640, 768, 1024, (100, 150, 300, 400)) for _ in range(n_images + 1)]
    state = pipe.init_state()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, sample in enumerate(samples):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = pipe.run_image(sample, state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        props = pipe.last_proposals
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        name = f"{tag} warm-up" if i == 0 else f"{tag} image {i}"
        if i:
            times.append(ms)
        log(f"  {name}: {ms:.1f} ms, proposals {props.num} (bucket {props.masks.shape[0]}), "
            f"selected {[(r.pure_index, r.final_index) for r in results]}, launches {delta}")
        _check_results(name, results, props, len(SENTENCES))
        short = {k: (delta[k], n) for k, n in min_launches.items() if delta[k] < n}
        if short:
            fail(f"{name}: kernels launched fewer times than the path needs: {short}")
    acc = [float(v) for v in (*state.pure, *state.final)]
    if not all(np.isfinite(acc)) or int(state.pure.count) != 2 * len(samples):
        fail(f"{tag}: accumulators wrong: {state}")
    log(f"{tag} pipeline: median {statistics.median(times):.1f} ms/img over {len(times)} images "
        f"(per image {[round(t, 1) for t in times]}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return pipe, samples


def _synthetic_full_bucket(pipe, P=64):
    """P live rectangle proposals in the canonical frame of a 480x640 image."""
    import torch

    from hybridgl_tpu_torch.kernels.masks import mask_to_box
    from hybridgl_tpu_torch.models.sam.amg import Proposals

    dev, C = pipe.device, pipe.cfg.canonical_size
    g = torch.Generator().manual_seed(2)
    masks = torch.zeros((P, C, C), dtype=torch.bool)
    for i in range(P):
        y0, x0 = (int(v) for v in torch.randint(0, 400, (2,), generator=g))
        hh, ww = (int(v) for v in torch.randint(20, 200, (2,), generator=g))
        masks[i, y0 : min(y0 + hh, 480), x0 : min(x0 + ww, 640)] = True
    masks = masks.to(dev)
    ones = torch.ones(P, device=dev)
    return Proposals(masks, mask_to_box(masks), ones, ones, torch.zeros((P, 2), device=dev),
                     masks.sum((-2, -1)).float(), ones.bool(), num=P, overflow=0)


def phase_profile(pipe, samples):
    """Stage wall times and device time by kernel for one more image, plus
    the scoring stages at a full bucket (random weights leave few proposals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sample = samples[-1]
    state = pipe.init_state()
    stage_ms = {}
    for _ in range(2):  # second pass is the one kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        props = pipe.propose(sample)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe._score_image(sample, props, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        stage_ms = {"proposals (encoder + AMG + cleanup)": (t1 - t0) * 1e3, "features + sentences": (t2 - t1) * 1e3}
    full = _synthetic_full_bucket(pipe)
    pipe._score_image(sample, full, pipe.init_state())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe._score_image(sample, full, pipe.init_state())
    torch.cuda.synchronize()
    stage_ms["features + sentences at P = 64 live"] = (time.perf_counter() - t0) * 1e3
    for k, v in stage_ms.items():
        log(f"  stage {k}: {v:.1f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run_image(sample, state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_total = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  profiled image: wall {wall:.1f} ms, device time {device_total:.1f} ms over "
        f"{sum(e.count for e in kernels)} kernels and copies (busy share {device_total / wall:.2f}, profiler on)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        log(f"  device {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")


def _wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_routes(pipe, samples):
    """RefCOCO ms/img and one decoder chunk (64 points) on the default route
    against the four switches at 0, in turns (default, off, off, default)."""
    import numpy as np
    import torch

    from hybridgl_tpu_torch.models.sam.amg import build_point_grid
    from hybridgl_tpu_torch.models.sam.prompt_encoder import dense_pe, no_mask_dense
    from hybridgl_tpu_torch.models.sam.sam import encode, predict_points, preprocess_padded

    cfg, p_sam = pipe.cfg, pipe.sam_params
    sample = samples[1]
    x = preprocess_padded(torch.from_numpy(sample.image_1024).cuda(), (sample.rh, sample.rw), cfg.sam)
    emb = encode(p_sam, x, cfg.sam)
    pe, dense = dense_pe(p_sam["prompt"], cfg.sam), no_mask_dense(p_sam["prompt"], cfg.sam, 1)[0]
    pts = torch.from_numpy(build_point_grid(8) * np.float32([sample.rw, sample.rh])).cuda()[:, None, :]
    labels = torch.ones((64, 1), device="cuda")
    per_route = {"default": [], "switches at 0": []}
    chunk = {"default": [], "switches at 0": []}
    for route in ("default", "switches at 0", "switches at 0", "default"):
        for k in DECODER_SWITCHES:
            if route == "default":
                os.environ.pop(k, None)
            else:
                os.environ[k] = "0"
        chunk[route].append(time_ms(lambda: predict_points(p_sam, emb, pts, labels, cfg.sam, True, pe=pe, dense=dense),
                                    reps=5))
        state = pipe.init_state()
        for smp in samples[1:3]:
            per_route[route].append(_wall_ms(lambda: pipe.run_image(smp, state))[0])
    for k in DECODER_SWITCHES:
        os.environ.pop(k, None)
    for route in per_route:
        log(f"  RefCOCO route {route}: median {statistics.median(per_route[route]):.1f} ms/img "
            f"({[round(t, 1) for t in per_route[route]]}); decoder chunk of 64 points "
            f"{[round(t, 2) for t in chunk[route]]} ms")


def phase_multicrop_stages(pipe, samples):
    """Stage times of one PhraseCut image: the five encoder passes, pass 1
    (full-image crop: 64 chunks; one layer-1 crop: 16 chunks), the pass-2
    re-decode of P = 128 survivors, and the whole proposal and scoring stages."""
    import torch

    from hybridgl_tpu_torch.models.sam import amg
    from hybridgl_tpu_torch.models.sam.decoder import predict_masks
    from hybridgl_tpu_torch.models.sam.prompt_encoder import dense_pe, embed_points, no_mask_dense
    from hybridgl_tpu_torch.models.sam.sam import encode, preprocess_padded

    cfg, p_sam = pipe.cfg, pipe.sam_params
    sample = samples[1]
    x = preprocess_padded(torch.from_numpy(sample.image_1024).cuda(), (sample.rh, sample.rw), cfg.sam)
    stages = {"encoder, one frame (x5 per image)": _wall_ms(lambda: encode(p_sam, x, cfg.sam))[0]}
    emb = encode(p_sam, x, cfg.sam)
    hw = (sample.h, sample.w)
    full_grid = amg.build_point_grid(cfg.amg.points_per_side)
    crop_grid = amg.build_point_grid(cfg.amg.points_per_side // cfg.amg.crop_n_points_downscale_factor)
    cy0, cx0, ch, cw = amg._crop_boxes_layer1(*hw, cfg.amg.crop_overlap_ratio)[3]
    for name, grid, origin, extent, rhw in (
        ("pass 1, full-image crop (64 chunks)", full_grid, (0, 0), hw, (sample.rh, sample.rw)),
        ("pass 1, one layer-1 crop (16 chunks, x4 per image)", crop_grid, (cy0, cx0), (ch, cw), (sample.rh, sample.rw)),
    ):
        stages[name] = _wall_ms(lambda: amg._score_candidates(p_sam, emb, grid, origin, extent, rhw, hw, cfg.sam,
                                                              cfg.amg, cfg.canonical_size))[0]
    P, g = cfg.amg.max_proposals, cfg.sam.embed_grid
    coords = torch.rand((P, 1, 2), device="cuda") * 1000
    sparse = embed_points(p_sam["prompt"], coords, torch.ones((P, 1), device="cuda"), cfg.sam)
    dense = emb[None].expand(P, g, g, -1) + no_mask_dense(p_sam["prompt"], cfg.sam, P)
    pe = dense_pe(p_sam["prompt"], cfg.sam)
    redecode = lambda: predict_masks(p_sam["decoder"], torch.zeros_like(emb), pe, sparse, cfg.sam,  # noqa: E731
                                     dense_prompts=dense, multimask_output=True)
    redecode()
    stages[f"pass 2 re-decode, P = {P} (K7 + K8 + K4)"] = _wall_ms(redecode)[0]
    for _ in range(2):  # the second pass is kept
        t_prop, props = _wall_ms(lambda: pipe.propose(sample))
        t_score, _ = _wall_ms(lambda: pipe._score_image(sample, props, pipe.init_state()))
    stages["proposals (5 encoder passes + multicrop AMG + cleanup)"] = t_prop
    stages[f"features + sentences (live bucket {props.masks.shape[0]})"] = t_score
    for k, v in stages.items():
        log(f"  PhraseCut stage {k}: {v:.1f} ms")


def main(argv):
    card = phase_environment()
    phase_build()
    results = phase_kernels()
    from hybridgl_tpu.core.config import AMG_PHRASECUT, AMG_REFCOCO
    from hybridgl_tpu_torch.kernels import launch_counts, reset_launch_counts

    phase_small_parity()
    weights = full_width_weights()
    counts, paths = {}, {}
    # each main path: the counts are set to 0 just before it and read just after
    for tag, amg, canonical, n_images, mins in (
        ("RefCOCO", AMG_REFCOCO, 640, 3, MIN_LAUNCHES_PER_IMAGE),
        ("PhraseCut", AMG_PHRASECUT, 1024, 2, MIN_LAUNCHES_PER_PHRASECUT_IMAGE),
    ):
        reset_launch_counts()
        paths[tag] = phase_pipeline(tag, amg, canonical, n_images, mins, weights)
        counts[tag] = launch_counts()
        missing = [k for k in mins if counts[tag][k] == 0]
        if missing:
            fail(f"kernels of the {tag} path never launched: {missing}")
    if "--profile" in argv:  # opt-in: CUPTI tracing is not part of the contract run
        phase_profile(*paths["RefCOCO"])
        phase_routes(*paths["RefCOCO"])
        phase_multicrop_stages(*paths["PhraseCut"])

    import torch

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(
            dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=sum(c[name] for c in counts.values()), **results[name])
        )
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
