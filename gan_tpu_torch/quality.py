"""Image-quality scores of generated images against targets (counterpart of
tools/eval_quality.py's functions).

Images are (N, H, W, C) fp32 tensors in [-1, 1], on any device; each score
is a Python float. ``l1`` and ``psnr`` (max_val 2, the range of [-1, 1]) and
``ssim`` (the port's ``tf.image.ssim``, max_val 2) run where the tensors lie.
``random_features`` is gan_tpu's Fréchet proxy extractor: the same numpy
``default_rng(seed)`` draws in the same order (three 3×3 stride-2 'SAME'
conv weights, then the projection), as torch convs in fp32 with TF32 off.
``frechet_distance`` fits a Gaussian to each feature set and takes scipy's
``sqrtm`` on the host in float64, as gan_tpu does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gan_tpu_torch.device import no_tf32
from gan_tpu_torch.ops.conv import conv2d_same
from gan_tpu_torch.ops.ssim import ssim as _ssim


def l1(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().mean())


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 2.0) -> float:
    mse = float(torch.square(a - b).mean())
    return float(10.0 * np.log10(max_val**2 / max(mse, 1e-12)))


def ssim(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean SSIM over the images, max_val 2."""
    return float(_ssim(a, b, max_val=2.0).mean())


@torch.no_grad()
def random_features(x: torch.Tensor, dim: int = 256, seed: int = 0) -> np.ndarray:
    """Fixed random strided-conv features (N, ``dim``): the proxy for Inception."""
    rng = np.random.default_rng(seed)
    h = x.float()
    c_in = h.shape[-1]
    with no_tf32():
        for c_out in (16, 32, 64):
            w = rng.normal(0, (2.0 / (9 * c_in)) ** 0.5, (3, 3, c_in, c_out)).astype(np.float32)
            w = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(h.device)
            h = F.relu(conv2d_same(h, w, 2))
            c_in = c_out
        pooled = h.mean(dim=(1, 2))
        proj = rng.normal(0, 1.0 / np.sqrt(pooled.shape[-1]),
                          (pooled.shape[-1], dim)).astype(np.float32)
        return (pooled @ torch.from_numpy(proj).to(h.device)).cpu().numpy()


def frechet_distance(fa: np.ndarray, fb: np.ndarray) -> float:
    """Fréchet distance between Gaussians fit to two activation sets."""
    from scipy import linalg

    mu_a, mu_b = fa.mean(0), fb.mean(0)
    ca = np.cov(fa, rowvar=False)
    cb = np.cov(fb, rowvar=False)
    covmean = linalg.sqrtm(ca @ cb)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.sum((mu_a - mu_b) ** 2) + np.trace(ca + cb - 2.0 * covmean))
