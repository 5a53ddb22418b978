"""Instance normalization, plain PyTorch (counterpart of gan_tpu/ops/norm.py).

Per-sample, per-channel moments over (H, W) of an NHWC tensor, epsilon 1e-5,
two-pass variance E[(x - mean)^2] in fp32; the output is cast back to the
input dtype so bf16 activations stay bf16. ``act`` is the activation
epilogue that the fused kernel carries (gan_tpu/ops/pallas_kernels.py:95-98).

This is the reference the CUDA kernel (gan_tpu_torch/ops/kernels.py) is held
against, and the version a CPU tensor runs.
"""

from __future__ import annotations

import torch

IN_EPS = 1e-5       # reference InstanceNormalization epsilon
LEAKY_SLOPE = 0.3   # tf.keras.layers.LeakyReLU default alpha
ACTS = (None, "leaky_relu", "relu")


def activation(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return x
    if act == "leaky_relu":
        return torch.where(x >= 0, x, LEAKY_SLOPE * x)
    if act == "relu":
        return torch.relu(x)
    raise ValueError(f"unknown act {act!r}; expected one of {ACTS}")


def instance_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, *,
                  act: str | None = None) -> torch.Tensor:
    """x: (N, H, W, C); scale, offset: (C,)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + IN_EPS) * scale.float() + offset.float()
    return activation(out, act).to(x.dtype)
