"""The port's own copy of ``hybridgl_tpu/eval/viz.py``, kept verbatim apart from its
imports and build paths, so that the port imports nothing of the JAX package.

Result visualisation (PIL-based; no matplotlib/cv2 dependence).

Equivalent of the reference's overlay writer (reference: demo.py:211-220)
and ``--show_results`` intent: selected mask tinted over the image, with a
contour, plus optional GT outline for eval inspection.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _contour(mask: np.ndarray) -> np.ndarray:
    """1-px boundary of a boolean mask (4-neighbourhood erosion diff)."""
    m = mask.astype(bool)
    er = m.copy()
    er[1:, :] &= m[:-1, :]
    er[:-1, :] &= m[1:, :]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def overlay_mask(
    image: np.ndarray,  # [h, w, 3] uint8
    mask: np.ndarray,  # [h, w] bool
    color: Tuple[int, int, int] = (0, 255, 0),
    alpha: float = 0.5,
    gt_mask: Optional[np.ndarray] = None,
    gt_color: Tuple[int, int, int] = (255, 0, 0),
) -> np.ndarray:
    out = image.astype(np.float32).copy()
    m = mask.astype(bool)
    out[m] = out[m] * (1 - alpha) + np.asarray(color, np.float32) * alpha
    out[_contour(m)] = color
    if gt_mask is not None:
        out[_contour(gt_mask.astype(bool))] = gt_color
    return out.astype(np.uint8)


def save_overlay(path: str, image, mask, **kw) -> None:
    from PIL import Image

    Image.fromarray(overlay_mask(np.asarray(image), np.asarray(mask), **kw)).save(path)
