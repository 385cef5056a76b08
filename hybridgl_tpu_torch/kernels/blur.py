"""Gaussian blur as a separable convolution (port of hybridgl_tpu/kernels/blur.py).

Matches OpenCV ``GaussianBlur(img, (k, k), 0)``: sigma derived from ksize,
border REFLECT_101 (the edge pixel is not repeated).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV getGaussianKernel: sigma <= 0 -> 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def gaussian_blur(img: torch.Tensor, ksize: int = 15, sigma: float = 0.0) -> torch.Tensor:
    """Blur the leading two axes of ``img`` ([H, W, ...]), reflect-101 border."""
    k = [float(v) for v in gaussian_kernel_1d(ksize, sigma)]
    pad = ksize // 2
    H, W = img.shape[0], img.shape[1]
    x = img.float()
    xp = x.index_select(0, _reflect101(H, pad, img.device))
    acc = 0
    for i in range(ksize):
        acc = acc + xp[i : i + H] * k[i]
    xp = acc.index_select(1, _reflect101(W, pad, img.device))
    acc = 0
    for i in range(ksize):
        acc = acc + xp[:, i : i + W] * k[i]
    if not img.is_floating_point():
        # cv2 rounds to nearest when writing back to uint8
        acc = torch.clamp(torch.round(acc), 0, 255)
    return acc.to(img.dtype)
