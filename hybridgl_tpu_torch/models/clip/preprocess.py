"""CLIP image preprocessing on the host, with PIL (port of hybridgl_tpu/models/clip/preprocess.py).

The counterpart of CLIP's ``_transform`` (clip/clip.py:79-86): bicubic
resize of the short side to the model resolution, center crop, RGB [0, 1]
normalised with the CLIP statistics. The pipeline builds its crops on the
device (pipeline/preprocess.py); this helper completes the standalone CLIP
API for users who encode arbitrary images.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_image_preprocess(image: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 [H, W, 3] RGB -> float32 [size, size, 3] normalized (NHWC)."""
    from PIL import Image

    pil = Image.fromarray(image)
    w, h = pil.size
    short = min(w, h)
    nw, nh = round(w * size / short), round(h * size / short)
    pil = pil.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    pil = pil.crop((left, top, left + size, top + size))
    x = np.asarray(pil, np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
