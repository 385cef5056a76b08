"""Analytic FLOP model of one image, for the MFU metrics.

Source: a frozen copy of the measured program's ``utils/flops.py`` (itself the
reference package's model, function for function), reading the settings of a
configuration file (``benchlib.config.model_settings``) in place of the
program's config classes. Matmul and convolution FLOPs, 2 a multiply-add, of
the SAM encoder, the canonical SAM decoder, the hybrid fusion, GEM and the
text encoder. ``gem_flops`` counts 10.14% under PyTorch's own count of the
GEM forward (1.5% of an image), as the original does.
"""

from __future__ import annotations

import math

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


def sam_encoder_flops(sam) -> float:
    """ImageEncoderViT forward on one 1024^2 frame.

    Windowed blocks attend within window_size^2 tokens over a padded
    (ceil(G/ws)*ws)^2 grid (reference: image_encoder.py:243-289); global
    blocks attend over all G^2 tokens. The decomposed rel-pos einsums
    (reference: image_encoder.py:292-361) contribute
    2*T_attn*(Sh+Sw)*head_dim per head — included.
    """
    G = sam.embed_grid  # 64
    T = G * G
    W = sam.encoder_width
    ws = sam.window_size
    Gp = math.ceil(G / ws) * ws
    T_win = Gp * Gp  # padded token count actually attending in windows
    n_global = len(sam.encoder_global_idx)
    n_win = sam.encoder_depth - n_global

    def relpos(T_attn, side):
        # q @ rel_h + q @ rel_w per head: 2 * T_attn * side * head_dim * H
        return 2 * _mm(T_attn, side, W)

    win = vit_block_flops(T, ws * ws, W, sam.mlp_ratio, T_attn=T_win) + relpos(
        T_win, ws
    )
    glo = vit_block_flops(T, T, W, sam.mlp_ratio) + relpos(T, G)
    patch = _mm(T, W, sam.patch_size * sam.patch_size * 3)
    neck = _mm(T, sam.prompt_dim, W) + _mm(T, sam.prompt_dim, sam.prompt_dim * 9)
    return n_win * win + n_global * glo + patch + neck


def sam_decode_flops(sam, n_points: int) -> float:
    """Prompt-encode + TwoWayTransformer + upscale + hypernetwork product
    for ``n_points`` single-point prompts (multimask).

    Two-way layers run {token self-attn, t2i, MLP, i2t} at attention
    channel dim prompt_dim/2 (reference: transformer.py:109-182,
    downsample_rate=2); the output upscaling is two stride-2 deconvs
    (reference: mask_decoder.py:53-59).

    This is the CANONICAL (reference-architecture) count, the one an MFU
    figure uses: MFU divides the model's defined work by time, so
    algorithmic savings of the implementation (side-switched cross
    attentions, shared layer-0 image side) show up as throughput, not as
    an MFU discount. What the decoder actually executes is
    ``sam_decode_flops_executed``, ~45% LOWER at production shapes.
    """
    B = n_points
    D = sam.prompt_dim  # 256
    Da = D // 2  # attention channels (downsample 2)
    G = sam.embed_grid
    Ti = G * G  # image tokens
    Tt = sam.num_mask_tokens + 1 + 2  # mask+iou tokens + point + pad  ~7
    per_layer = (
        # token self-attn (q/k/v/out at Da) + scores
        _mm(Tt, 3 * Da, D) + _mm(Tt, Da, D) + 2 * _mm(Tt, Tt, Da)
        # t2i: q from tokens, k/v from image
        + _mm(Tt, Da, D) + _mm(Ti, 2 * Da, D) + _mm(Tt, Da, D)
        + 2 * _mm(Tt, Ti, Da)
        # token MLP
        + 2 * _mm(Tt, sam.decoder_mlp_dim, D)
        # i2t: q from image, k/v from tokens
        + _mm(Ti, Da, D) + _mm(Tt, 2 * Da, D) + _mm(Ti, Da, D)
        + 2 * _mm(Ti, Tt, Da)
    )
    final_attn = _mm(Tt, Da, D) + _mm(Ti, 2 * Da, D) + _mm(Tt, Da, D) + 2 * _mm(
        Tt, Ti, Da
    )
    # upscale deconvs 2x2/s2: each output pixel sees exactly one weight tap
    up1 = _mm((2 * G) ** 2, D // 4, D)
    up2 = _mm((4 * G) ** 2, D // 8, D // 4)
    hyper = sam.num_mask_tokens * 3 * _mm(1, D // 8, D)  # 3-layer MLPs
    mask_prod = _mm(sam.num_mask_tokens, (4 * G) ** 2, D // 8)
    iou_head = sam.iou_head_depth * _mm(1, sam.iou_head_hidden, D)
    return B * (
        sam.decoder_depth * per_layer
        + final_attn
        + up1
        + up2
        + hyper
        + mask_prod
        + iou_head
    )


def sam_decode_flops_executed(sam, n_points: int, token_lanes: int | None = None) -> float:
    """FLOPs our decoder IMPLEMENTATION executes for ``n_points`` prompts.
    ``token_lanes``: the token lanes per head that the side-switched products
    run over (the kernels and their plain versions pad the 7 tokens to 8;
    default: the tokens themselves, the reference's count).

    Models models/sam/decoder.py's shared-image path (the CUDA kernels
    compute the same contractions as its plain form): the image side is
    projected ONCE through layer 0 (two_way_transformer shared_image=True),
    every cross attention is side-switched (the image stream is only read
    by the two attention products, whose contraction runs over the full
    prompt_dim C instead of separate q/k/v image projections), and the
    upscale tail is the two deconvs and the hypernetwork product.
    """
    B = n_points
    D = sam.prompt_dim  # 256
    Da = D // 2  # attention channels (downsample 2)
    h = sam.decoder_heads
    hd = Da // h
    G = sam.embed_grid
    Ti = G * G
    T = sam.num_mask_tokens + 1 + 2  # mask+iou tokens + point + pad ~7
    L = sam.decoder_depth
    Tl = token_lanes or T  # lanes of the products over the image stream

    self_attn = 4 * _mm(T, Da, D) + 2 * (2 * T * T * Da)
    mlp = 2 * _mm(T, sam.decoder_mlp_dim, D)
    # layer 0 t2i (_attn_shared_kv): q/out proj per prompt; k/v shared (below)
    t2i_l0 = 2 * _mm(T, Da, D) + 2 * (2 * T * Ti * Da)
    # layer 0 i2t (_attn_shared_q): token k/v proj, scores over hd, readout
    # contraction over (heads*T) into D
    i2t_l0 = 2 * _mm(T, Da, D) + 2 * Tl * Ti * Da + _mm(T, D, Da) + 2 * Ti * (h * Tl) * D
    # later-layer t2i (_t2i_attn): q proj + qw fold + scores/ctx over C
    t2i = 2 * _mm(T, Da, D) + 2 * (2 * (h * Tl) * Ti * D) + 2 * T * D * (h * D)
    # later-layer i2t (_i2t_attn): token k/v proj + wk/vo folds + scores/ctx
    i2t = 4 * _mm(T, Da, D) + 2 * (2 * (h * Tl) * Ti * D)
    per_point = (
        L * (self_attn + mlp)
        + (t2i_l0 + i2t_l0)
        + (L - 1) * (t2i + i2t)
        + t2i  # final attention
    )
    # upscale tail (algorithmic): z1, z2, hypernetwork contraction
    c4, c8 = D // 4, D // 8
    nsel = sam.num_multimask_outputs
    up = _mm(Ti, 4 * c4, D) + _mm(Ti * 4, 4 * c8, c4) + _mm(nsel, Ti * 16, c8)
    hyper = sam.num_mask_tokens * (2 * _mm(1, D, D) + _mm(1, c8, D))
    iou_head = (sam.iou_head_depth - 1) * _mm(1, sam.iou_head_hidden, D) + _mm(
        1, sam.num_mask_tokens, sam.iou_head_hidden
    )
    per_point += up + hyper + iou_head
    # shared (per chunk, not per point): layer-0 image k/v/q projections,
    # dense positional encoding, weight-only folds (wvo etc.)
    shared = 3 * _mm(Ti, Da, D) + _mm(Ti, Da, 2) + 3 * 2 * h * D * hd * D
    return B * per_point + shared


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
    enc = n_crops * sam_encoder_flops(cfg.sam)
    dec = sam_decode_flops(cfg.sam, points)
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
