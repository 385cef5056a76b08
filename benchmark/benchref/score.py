"""Plain-PyTorch feature and sentence stages of HybridGL on given proposals:
the global/local crops, the G2L fusion features, the GEM patch features, and
for each sentence the text ensemble, the CLIP scores, the pure pick, the
softmax top-k with the sticky k1/k2 clamp, the box-relation scores, the GEM
heatmap with its direction prior, the blend and the final pick.

Source: a frozen copy of ``tests/torch_ref_driver.py`` (the test suite's
restatement of the reference's per-image driver, ``Hybridgl_main.py:79-231``)
with cv2 replaced by plain tensors: the Gaussian blur is OpenCV's
``GaussianBlur(img, (15, 15), 0)`` (its sigma, a reflect-101 border, the
result rounded to uint8), ``bitwise_and``/``add`` are products and sums of
uint8 values. The relation predicate is ``tests/test_guidance.py``'s
``np_relation_boxes``. It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .clip import g2l_forward, gem_features

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _vec(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)[:, None, None]


def gaussian_blur_u8(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """OpenCV GaussianBlur(img, (k, k), 0) of a [3, h, w] float image of uint8
    values: sigma from ksize, reflect-101 border, rounded to uint8 values."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float64) - (ksize - 1) * 0.5
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    k = (k / k.sum()).float().to(img.device)
    pad = ksize // 2
    y = F.pad(img[None], (pad, pad, pad, pad), mode="reflect")
    y = F.conv2d(y, k.view(1, 1, 1, -1).expand(3, 1, 1, ksize), groups=3)
    y = F.conv2d(y, k.view(1, 1, -1, 1).expand(3, 1, ksize, 1), groups=3)
    return torch.clamp(torch.round(y[0]), 0, 255)


def resize_sq(x: torch.Tensor, size: int) -> torch.Tensor:
    """T.Resize((size, size)) of [N, C, H, W] tensors: bilinear, no antialias."""
    return F.interpolate(x, (size, size), mode="bilinear", align_corners=False)


@torch.no_grad()
def build_crops(image: torch.Tensor, masks: torch.Tensor, crop: int, ksize: int):
    """image [h, w, 3] uint8 values (float or uint8), masks [P, h, w] bool ->
    (global, local) crops [P, 3, crop, crop] (Hybridgl_main.py:92-125)."""
    dev = image.device
    img = image.permute(2, 0, 1).float()
    blurred = gaussian_blur_u8(img, ksize)
    m = masks.float()[:, None]
    composite = img[None] * m + blurred[None] * (1 - m)
    g = resize_sq(composite / 255.0, crop)
    g = (g - _vec(IMAGENET_MEAN, dev)) / _vec(IMAGENET_STD, dev)
    original = (img / 255.0 - _vec(IMAGENET_MEAN, dev)) / _vec(IMAGENET_STD, dev)
    local = original[None] * m + (1 - m) * _vec(CLIP_MEAN, dev)
    return g, resize_sq(local, crop)


@torch.no_grad()
def fusion_features(model, image: torch.Tensor, masks: torch.Tensor, cfg: dict, chunk: int = 16) -> torch.Tensor:
    """G2L features [P, E] of the proposals ``masks`` [P, h, w], in chunks of proposals."""
    out = []
    for s in range(0, masks.shape[0], chunk):
        g, loc = build_crops(image, masks[s: s + chunk], cfg["crop_size"], cfg["blur_ksize"])
        out.append(g2l_forward(model, loc, g, masks[s: s + chunk].float(), cfg["guidance"]["masking_block"]))
    return torch.cat(out)


@torch.no_grad()
def gem_patch_features(model, image: torch.Tensor, gem: dict) -> torch.Tensor:
    """Normalized GEM patch features [G*G, E] of the image [h, w, 3]: bilinear
    squash to the GEM frame, uint8 rounding, OpenAI CLIP normalization."""
    dev = image.device
    size = gem["img_size"]
    x = resize_sq(image.permute(2, 0, 1)[None].float(), size)
    x = torch.round(x) / 255.0
    x = (x - _vec(CLIP_MEAN, dev)) / _vec(CLIP_STD, dev)
    pf = gem_features(model, x, gem["depth"], gem["ss_attn_iters"], gem.get("ss_attn_temp"))[0]
    return pf / pf.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def relation(boxi, boxj, si, sj, rela):
    """The reference's relation predicate (utils.py:240-268) on xywh boxes."""
    if rela == "none":
        return si
    if rela == "left":
        return si * sj * float((boxi[0] + boxi[2] / 2) < (boxj[0] + boxj[2] / 2))
    if rela == "right":
        return si * sj * float((boxi[0] + boxi[2] / 2) > (boxj[0] + boxj[2] / 2))
    if rela == "up":
        return si * sj * float((boxi[1] + boxi[3] / 2) < (boxj[1] + boxj[3] / 2))
    if rela == "down":
        return si * sj * float((boxi[1] + boxi[3] / 2) > (boxj[1] + boxj[3] / 2))
    if rela == "big":
        return si * sj * float((boxi[2] * boxi[3]) > (boxj[2] * boxj[3]))
    if rela == "small":
        return si * sj * float((boxi[2] * boxi[3]) < (boxj[2] * boxj[3]))
    if rela == "within":
        x1 = max(boxi[0], boxj[0])
        x2 = max(x1, min(boxi[0] + boxi[2], boxj[0] + boxj[2]))
        y1 = max(boxi[1], boxj[1])
        y2 = max(y1, min(boxi[1] + boxi[3], boxj[1] + boxj[3]))
        return si * sj * (x2 - x1) * (y2 - y1) / (boxi[2] * boxi[3])
    return si


def dir_mask(flag: str, h: int, w: int, dev) -> torch.Tensor:
    """gen_dir_mask (utils.py:135-161; up and down are ones, as upstream)."""
    if flag == "left":
        return torch.linspace(1, 0, w, device=dev).expand(h, w)
    if flag == "right":
        return torch.linspace(0, 1, w, device=dev).expand(h, w)
    if flag == "middle":
        return torch.cat([torch.linspace(0, 1, w // 2, device=dev),
                          torch.linspace(1, 0, w - w // 2, device=dev)]).expand(h, w)
    return torch.ones(h, w, device=dev)


class SentenceRef(NamedTuple):
    score: torch.Tensor  # [P] CLIP scores of the live proposals (logits)
    sm: torch.Tensor  # [P] their softmax
    pure: int
    topk: list  # the top-k1 indices
    blend: torch.Tensor  # [k1] blended guidance scores
    final: int


@torch.no_grad()
def sentence(model, tokens: torch.Tensor, n_others: int, parsed, feats, boxes_xywh: np.ndarray, gem_pf,
             masks: torch.Tensor, k1: int, k2: int, cfg: dict, topk=None) -> SentenceRef:
    """One sentence over the live proposals: ``tokens`` [2 + K, L] (sentence,
    noun phrase, 'a photo of <noun>' rows), ``feats`` [P, E], boxes [P, 4]
    xywh, ``masks`` [P, h, w] bool, the clamped k1/k2. ``topk``, if given,
    is the top-k1 set the guidance blends (by default the softmax's own)."""
    g = cfg["guidance"]
    dev = feats.device
    r, alpha = g["r"], g["alpha"]
    tf = model.encode_text(tokens[: 2 + n_others])
    sent_f, np_f = tf[0:1], tf[1:2]
    im = feats / feats.norm(dim=1, keepdim=True)
    scale = model.logit_scale.exp()

    def calc(t):
        return (scale * im @ (t / t.norm(dim=1, keepdim=True)).t())[:, 0]

    score = calc(r * sent_f + (1 - r) * np_f)
    pure = int(torch.argmax(score))
    sm = torch.softmax(score, 0)
    maxidxs = [int(i) for i in (torch.topk(sm, k=k1)[1] if topk is None else topk)]
    top = np.zeros(k1)
    if n_others == 0:
        for i in range(k1):
            for j in maxidxs:
                top[i] += relation(boxes_xywh[maxidxs[i]], boxes_xywh[j], float(sm[maxidxs[i]]), float(sm[j]),
                                   parsed.rela_flag)
    else:
        other = tf[2: 2 + n_others].sum(0, keepdim=True) / n_others
        sm_neg = torch.softmax(calc(other), 0)
        _, maxneg = torch.topk(sm_neg, k=k2)
        for i in range(k1):
            for j in maxneg:
                top[i] += relation(boxes_xywh[maxidxs[i]], boxes_xywh[int(j)], float(sm[maxidxs[i]]),
                                   float(sm_neg[int(j)]), parsed.rela_flag)
    top = torch.softmax(torch.tensor(top, dtype=torch.float32, device=dev), 0)

    h, w = masks.shape[-2:]
    G = int(round(gem_pf.shape[0] ** 0.5))
    npn = np_f[0] / np_f[0].norm().clamp_min(1e-6)
    rel = (gem_pf @ npn).reshape(G, G)
    size = cfg["gem"]["img_size"]
    heat = F.interpolate(rel[None, None], (size, size), mode="bilinear", align_corners=False)
    heat = F.interpolate(heat, (h, w), mode="bilinear", align_corners=False, antialias=True)[0, 0]
    heat = (heat - heat.min()) / (heat.max() - heat.min())
    heat = heat * dir_mask(parsed.dir_flag, h, w, dev)
    heat = heat / heat.mean()
    black = {"big": g["black_big"], "small": g["black_small"]}.get(parsed.rela_flag, g["black_other"])
    m = masks.float()
    gem = ((heat * (2 - black) * m).sum((-1, -2)) / m.sum((-1, -2))
           - (heat * black * (1 - m)).sum((-1, -2)) / (1 - m).sum((-1, -2)))
    blend = top * (1 - alpha) + alpha * gem[maxidxs]
    final = maxidxs[int(torch.argmax(blend))]
    return SentenceRef(score, sm, pure, maxidxs, blend, final)
