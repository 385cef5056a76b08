"""The least time the card could take for the port's own kernels, and the
launches one image makes at a configuration's shapes.

``kernel_work`` and ``bound_ms`` are a frozen copy of the measured program's
``tools/check_kernels.py`` (operations and bytes a call needs: multiply-adds
count 2, every input byte read once and every output byte written once;
the bound is the larger of operations over the peak rate and bytes over the
memory rate). The peaks are the H100 SXM's published dense rates. The
launches and shapes an image makes follow the kernel table of ``PERF.md``:
the proposal stage's are its family's (``families/<name>.py:proposal_launches``),
the feature stage's :func:`feature_launches`; where the work depends on the
data (the NMS sweep's words), the least is counted, so a bound is never too high.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CUDA_CORE_F32 = ("nms",)


def kernel_work(name: str, **d) -> tuple[int, int]:
    """(operations, bytes) one call of kernel ``name`` needs at the shapes
    ``d``: multiply-adds count 2, every input byte is read once and every
    output byte written once. Where the work depends on the data (the
    placement window of the pass-1 stats) it is what these inputs need.

    Shapes: the attention kernels take BH, S, hd, esize (bytes per q/k/v
    element) and G (rel-pos) or N (CLS-row bias rows); the pass-1 stats B, n,
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
    if name == "nms":  # ~15 f32 operations an IoU of the upper triangle; boxes, valid, the mask, keep, the count
        N, W = d["N"], -(-d["N"] // 64)
        written = sum(min(64, N - 64 * rb) * (W - rb) for rb in range(W))  # the upper triangle's words
        return 15 * N * (N - 1) // 2, 16 * N + N + 8 * (written + d["read_words"]) + N + 4
    raise ValueError(f"unknown kernel {name}")


def bound_ms(operations: int, nbytes: int, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    by_ops, by_bytes = operations / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def feature_launches(settings, bucket: int) -> list:
    """[(kernel, shapes)] of the G2L feature stage at a proposal bucket: the
    shared blocks over the local and global streams, then two streams a
    block, each CLIP attention one launch."""
    clip = settings.clip
    mb, L = settings.guidance.masking_block, clip.vision_layers
    hd = clip.vision_width // clip.vision_heads
    last = L - 2
    shared = [("clip_attention", dict(BH=2 * bucket * clip.vision_heads, S=clip.seq_len, hd=hd, N=2 * bucket,
                                       esize=2))] * mb
    late = [("clip_attention", dict(BH=bucket * clip.vision_heads, S=clip.seq_len, hd=hd, N=bucket, esize=2))] * (
        2 * (last + 2 - mb))
    return shared + late


# the device kernels one call of each modelled kernel launches, by the trace's label of
# each (``trace.OWN_KERNELS``): the decoder's score pass and T2I merge their splits in a
# second kernel, the NMS builds its bitmask and sweeps it in two
TRACE_KERNELS = {"flash_windowed_fused": {"K1 flash_windowed_fused": 1},
                 "flash_attention_fused": {"K2 flash_attention_fused": 1},
                 "clip_attention": {"K6 clip_attention": 1},
                 "pass1_stats_half": {"K5 pass1_stats_half": 1},
                 "upscale_hyper_blocked": {"K4 upscale_hyper_blocked": 1},
                 "i2t_ln_then_t2i": {"K3/K7/K8 decoder attention": 1, "K3/K8 t2i_combine": 1},
                 "i2t_ln_update": {"K3/K7/K8 decoder attention": 1},
                 "t2i_ctx": {"K3/K7/K8 decoder attention": 1, "K3/K8 t2i_combine": 1},
                 "nms": {"N1 nms": 2}}


def launches_by_label(launches) -> dict:
    """{trace label: device kernels} that the modelled ``launches`` make: the
    bound holds for the traced kernels only where these are what the trace counts."""
    out = {}
    for name, _ in launches:
        for label, n in TRACE_KERNELS[name].items():
            out[label] = out.get(label, 0) + n
    return out


def total_bound_ms(launches) -> float:
    return sum(bound_ms(*kernel_work(name, **d), PEAK_F32_FLOPS if name in CUDA_CORE_F32 else PEAK_BF16_FLOPS)[0]
               for name, d in launches)
