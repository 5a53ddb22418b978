"""SSIM as ``tf.image.ssim`` computes it (counterpart of gan_tpu/ops/ssim.py).

An 11-tap Gaussian window (sigma 1.5), VALID, k1 = 0.01, k2 = 0.03, in fp32.
The window is separable: a depthwise ``F.conv2d`` (one group per channel)
along W, then along H. ``ssim_loss`` is gan_tpu's corrected
``--generator-loss ssim``: 1 − mean SSIM(G(x), y) with max_val 2, for images
in [-1, 1].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter2d(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable filter, VALID, of an NCHW tensor."""
    c, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.view(1, 1, 1, k).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, k, 1).repeat(c, 1, 1, 1), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, *, max_val: float, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM of NHWC ``a`` against ``b``: (N, H, W, C) -> (N,), fp32."""
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    win = torch.from_numpy(_gaussian_kernel(filter_size, filter_sigma)).to(a.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu_a, mu_b = _filter2d(a, win), _filter2d(b, win)
    var_a = _filter2d(a * a, win) - mu_a * mu_a
    var_b = _filter2d(b * b, win) - mu_b * mu_b
    cov = _filter2d(a * b, win) - mu_a * mu_b

    luminance = (2.0 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1)
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    return (luminance * cs).mean(dim=(1, 2, 3))


def ssim_loss(gen_output: torch.Tensor, target: torch.Tensor, *,
              max_val: float = 2.0) -> torch.Tensor:
    """1 − mean SSIM(G(x), y), the images in [-1, 1] (dynamic range 2)."""
    return 1.0 - ssim(gen_output, target, max_val=max_val).mean()
