"""Global/local crop preprocessing on the card (port of hybridgl_tpu/pipeline/preprocess.py).

  global view  sharp in-mask pixels + gaussian-blurred background, resized
               to the crop size, ImageNet-normalized (Hybridgl_main.py:99-118)
  local view   ImageNet-normalized image inside the mask, the raw-space CLIP
               pixel mean outside (a reference quirk, reproduced), resized
               (Hybridgl_main.py:93,120-122)
"""

from __future__ import annotations

import functools

import torch

from ..kernels.blur import gaussian_blur
from ..kernels.resize import resize_bilinear
from ..utils.transfer import upload

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)


@functools.lru_cache(maxsize=None)
def constants(device: torch.device):
    """(ImageNet mean x 255, ImageNet std x 255, raw CLIP pixel mean) on
    ``device``, made once a device: a stage that uploads them would copy
    from the host at every image (and could not be captured)."""
    imagenet = (upload(v, device, torch.float32) * 255.0 for v in (IMAGENET_MEAN, IMAGENET_STD))
    return (*imagenet, upload(CLIP_PIXEL_MEAN, device, torch.float32))


def reflect_fill(img: torch.Tensor, hw) -> torch.Tensor:
    """Mirror the valid (h, w) corner into the padding (reflect-101), so the
    blur sees cv2's border at the true image edge; ``hw`` numbers or device
    scalars (read by no one on the host)."""
    H, W = img.shape[0], img.shape[1]
    dev = img.device
    h, w = (upload(v, dev, torch.long) for v in (hw[0], hw[1]))
    i = torch.arange(H, device=dev)
    j = torch.arange(W, device=dev)
    ri = torch.minimum(torch.clamp(torch.where(i < h, i, 2 * h - 2 - i), min=0), h - 1)
    rj = torch.minimum(torch.clamp(torch.where(j < w, j, 2 * w - 2 - j), min=0), w - 1)
    return img[ri][:, rj]


def build_crops(image_u8: torch.Tensor, masks: torch.Tensor, hw, crop_size: int = 224, blur_ksize: int = 15):
    """image_u8 [C, C, 3] canonical frame, masks [P, C, C] bool -> (global,
    local) crops, each [P, crop, crop, 3] f32; ``hw`` the valid extent
    (numbers or device scalars)."""
    img = image_u8.float()
    blurred = gaussian_blur(reflect_fill(img, hw), blur_ksize)
    imagenet_mean, imagenet_std, clip_mean = constants(image_u8.device)

    m = masks.float()[..., None]  # [P, C, C, 1]
    # global: sharp foreground + blurred background (cv2 writes the blurred
    # background back as uint8 before adding)
    composite = img * m + torch.round(blurred * (1.0 - m))
    g = resize_bilinear(composite, (crop_size, crop_size), src_hw=hw, axis=1)
    g = (g - imagenet_mean) / imagenet_std
    # local: normalized image in-mask, raw CLIP mean outside
    norm = (img - imagenet_mean) / imagenet_std
    local_full = norm * m + (1.0 - m) * clip_mean
    loc = resize_bilinear(local_full, (crop_size, crop_size), src_hw=hw, axis=1)
    return g, loc
