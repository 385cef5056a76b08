"""Visual prompting utilities on tensors (port of hybridgl_tpu/pipeline/visual_prompts.py).

The prompt helpers of the original code base (utils.py:270-352):
blur-background, ellipse ("circle") outline, blackout, mask -> center and
size, mask -> RGB, gaussian noise. The blur variant is what the evaluation
scripts inline; the rest exist for users of that utility surface.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..kernels.blur import gaussian_blur


def mask2chw(mask: torch.Tensor):
    """(center_y, center_x), height, width of a boolean mask [H, W], as
    0-d integer tensors (utils.py:280-289)."""
    m = mask.float()
    total = torch.clamp(m.sum(), min=1.0)
    H, W = mask.shape
    dev = mask.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    cy = torch.floor((m.sum(1) * ys).sum() / total).int()
    cx = torch.floor((m.sum(0) * xs).sum() / total).int()
    in_h, in_w = mask.bool().any(dim=1), mask.bool().any(dim=0)
    ih, iw = torch.arange(H, device=dev), torch.arange(W, device=dev)
    hh = torch.where(in_h, ih, -1).max() - torch.where(in_h, ih, H).min() + 1
    ww = torch.where(in_w, iw, -1).max() - torch.where(in_w, iw, W).min() + 1
    return (cy, cx), hh, ww


def mask2img(mask: torch.Tensor) -> torch.Tensor:
    """bool [H, W] -> uint8 [H, W, 3] (utils.py:270-278)."""
    g = mask.to(torch.uint8) * 255
    return torch.stack([g, g, g], dim=-1)


def apply_visual_prompts(
    image: torch.Tensor,  # [H, W, 3] uint8/float
    mask: torch.Tensor,  # [H, W] bool
    visual_prompt_type: Sequence[str] = ("circle",),
    color: Tuple[int, int, int] = (255, 0, 0),
    thickness: float = 1.0,
    blur_ksize: int = 15,
) -> torch.Tensor:
    """Blur-background / ellipse-outline / blackout prompting (utils.py:292-345)."""
    img = image.float()
    m = mask.float()[..., None]
    out = img

    if "blur" in visual_prompt_type:
        blurred = torch.round(gaussian_blur(img, blur_ksize))
        out = out * m + blurred * (1.0 - m)

    if "circle" in visual_prompt_type:
        (cy, cx), hh, ww = mask2chw(mask)
        H, W = mask.shape
        ys = (torch.arange(H, dtype=torch.float32, device=mask.device) - cy)[:, None]
        xs = (torch.arange(W, dtype=torch.float32, device=mask.device) - cx)[None, :]
        a = torch.clamp(ww.float() / 2.0, min=1.0)
        b = torch.clamp(hh.float() / 2.0, min=1.0)
        # normalized radial distance; a ring of ~`thickness` px around r == 1
        r = torch.sqrt((xs / a) ** 2 + (ys / b) ** 2)
        band = torch.abs(r - 1.0) * torch.minimum(a, b) <= thickness
        out = torch.where(band[..., None], torch.tensor(color, dtype=torch.float32, device=mask.device), out)

    if "black" in visual_prompt_type:
        out = out * m

    return out.to(image.dtype)


def gen_gauss_img(generator: torch.Generator, mean: float, sigma: float, image: torch.Tensor) -> torch.Tensor:
    """Additive gaussian noise drawn from ``generator`` (on the image's
    device), clipped to [0, 255] (utils.py:347-352)."""
    noise = mean + sigma * torch.randn(image.shape, generator=generator, dtype=torch.float32, device=image.device)
    return torch.clamp(image.float() + noise, 0.0, 255.0)
