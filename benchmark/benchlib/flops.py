"""Analytic FLOP model of one image, for the MFU metrics.

Source: a frozen copy of the measured program's ``utils/flops.py`` (itself the
reference package's model, function for function), reading the settings of a
configuration file (``benchlib.config.model_settings``) in place of the
program's config classes. Matmul and convolution FLOPs, 2 a multiply-add, of
the proposal model's encoder and canonical decoder (its family's
``encoder_flops`` and ``decode_flops``, ``families/<name>.py``), the hybrid
fusion, GEM and the text encoder. ``gem_flops`` counts 10.14% under PyTorch's own count of the
GEM forward (1.5% of an image), as the original does.
"""

from __future__ import annotations

# dense bf16 tensor-core peak per card, by the prefix of torch.cuda.get_device_name()
PEAK_FLOPS_BY_DEVICE = {
    "NVIDIA H100": 989e12,  # H100 SXM, the published dense bf16 figure
}


def _mm(m: int, n: int, k: int) -> float:
    """FLOPs of an [m,k] @ [k,n] matmul (2 per multiply-add)."""
    return 2.0 * m * n * k


def vit_block_flops(
    T: int, S: int, W: int, mlp_ratio: float = 4.0, T_attn: int | None = None
) -> float:
    """One pre-LN transformer block.

    T: tokens seen by the projections/MLP; S: attention context length;
    T_attn: tokens doing attention (padded window count may exceed T).
    """
    T_attn = T if T_attn is None else T_attn
    proj = _mm(T, 3 * W, W) + _mm(T, W, W)  # qkv + out
    attn = 2 * _mm(T_attn, S, W)  # QK^T + PV (summed over heads)
    mlp = 2 * _mm(T, int(mlp_ratio * W), W)
    return proj + attn + mlp


def clip_vit_flops(clip, n_streams: float, tokens: int | None = None) -> float:
    """CLIP vision tower forward over ``n_streams`` token streams."""
    T = tokens if tokens is not None else clip.seq_len
    W = clip.vision_width
    stem = _mm(T - 1 if tokens is None else T, W, clip.patch_size**2 * 3)
    blocks = clip.vision_layers * vit_block_flops(T, T, W)
    proj = _mm(T, clip.embed_dim, W)
    return n_streams * (stem + blocks + proj)


def clip_fusion_flops(cfg, n_proposals: int) -> float:
    """Hybrid fusion forward (reference: model/backbone.py:117-309).

    Every mode runs the shared stem + blocks over the local and global
    batches (2N streams through effectively all vision_layers; G2L&L2G
    runs four streams from masking_block on). Counted per mode.
    """
    clip = cfg.clip
    N = n_proposals
    mb = cfg.guidance.masking_block
    L = clip.vision_layers
    per_block = vit_block_flops(clip.seq_len, clip.seq_len, clip.vision_width)
    stem = _mm(clip.num_patches, clip.vision_width, clip.patch_size**2 * 3)
    proj = _mm(1, clip.embed_dim, clip.vision_width)
    if cfg.fusion_mode == "crop":
        streams_late = N  # local only
    elif cfg.fusion_mode == "G2L&L2G":
        streams_late = 4 * N
    else:
        streams_late = 2 * N
    if cfg.fusion_mode == "attn_masking" and cfg.compat.attn_masking_early_exit:
        L = L - 1
    early = 2 * N * mb * per_block
    late = streams_late * (L - mb) * per_block
    return 2 * N * stem + early + late + streams_late * proj


def gem_flops(cfg) -> float:
    """GEM image features at gem.img_size (reference consumes gem-torch,
    Hybridgl_main.py:36-39; ours runs qq/kk/vv self-self attention over
    the last gem.depth blocks alongside the plain path — roughly 2x the
    attention term there, counted as an extra half block)."""
    clip = cfg.clip
    g = cfg.gem.img_size // clip.patch_size
    T = g * g + 1
    W = clip.vision_width
    stem = _mm(T - 1, W, clip.patch_size**2 * 3)
    plain = clip.vision_layers * vit_block_flops(T, T, W)
    ss_extra = cfg.gem.depth * (0.5 * vit_block_flops(T, T, W))
    proj = _mm(T, clip.embed_dim, W)
    return stem + plain + ss_extra + proj


def text_flops(cfg, n_streams: int) -> float:
    clip = cfg.clip
    T = clip.context_length
    W = clip.text_width
    blocks = clip.text_layers * vit_block_flops(T, T, W)
    return n_streams * (blocks + _mm(1, clip.embed_dim, W))


def pipeline_flops_per_image(
    cfg, n_proposals: int, n_sentences: int
) -> dict:
    """FLOPs the pipeline performs for one image, by stage."""
    n_crops = 1
    points = cfg.amg.points_per_side**2
    if cfg.amg.crop_n_layers >= 1:
        n_crops = 1 + 4  # crop layer 1 -> 2x2 grid + full frame
        points = points + 4 * (
            cfg.amg.points_per_side // cfg.amg.crop_n_points_downscale_factor
        ) ** 2
    enc = n_crops * cfg.family.encoder_flops(cfg.sam)
    dec = cfg.family.decode_flops(cfg.sam, points)
    fusion = clip_fusion_flops(cfg, n_proposals)
    gem = gem_flops(cfg)
    text = n_sentences * text_flops(cfg, 2 + 1)  # sent + np + ~1 negative
    total = enc + dec + fusion + gem + text
    return {
        "sam_encoder": enc,
        "sam_decode": dec,
        "clip_fusion": fusion,
        "gem": gem,
        "text": text,
        "total": total,
    }


def peak_flops(device_kind: str) -> float | None:
    """Peak of the card named ``device_kind`` (torch.cuda.get_device_name()),
    None for a card the table does not list. The longest matching prefix
    wins, so a later, more specific entry beats a general one."""
    best = None
    for k, v in PEAK_FLOPS_BY_DEVICE.items():
        if device_kind.startswith(k) and (best is None or len(k) > len(best[0])):
            best = (k, v)
    return best[1] if best else None
