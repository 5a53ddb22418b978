"""Instance normalization, plain PyTorch (counterpart of gan_tpu/ops/norm.py).

Per-sample, per-channel moments over (H, W) of an NHWC tensor, epsilon 1e-5,
two-pass variance E[(x - mean)^2] in fp32; the output is cast back to the
input dtype so bf16 activations stay bf16. ``act`` is the activation
epilogue that the fused kernel carries (gan_tpu/ops/pallas_kernels.py:95-98).

This is the reference the CUDA kernels (gan_tpu_torch/ops/kernels.py) are
held against, and the version a CPU tensor runs: on the CPU autograd takes
the gradient of :func:`instance_norm`, and :func:`instance_norm_backward`
writes that gradient out as the backward kernel (K2) computes it.
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


def instance_norm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor):
    """The VJP of :func:`instance_norm` with ``act=None``, in the explicit form
    of gan_tpu/ops/pallas_kernels.py:_in_bwd_kernel, in fp32: with
    x̂ = (x − mean)·inv, dx = inv·(dy·γ − mean(dy·γ) − x̂·mean(dy·γ·x̂)),
    dγ = Σ dy·x̂ and dβ = Σ dy over (N, H, W). Returns (dx in x's dtype,
    dscale, doffset in fp32)."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt((xf - mean).square().mean(dim=(1, 2), keepdim=True) + IN_EPS)
    xhat = (xf - mean) * inv
    dyg = dyf * scale.float()
    m1 = dyg.mean(dim=(1, 2), keepdim=True)
    m2 = (dyg * xhat).mean(dim=(1, 2), keepdim=True)
    dx = inv * (dyg - m1 - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=(0, 1, 2)), dyf.sum(dim=(0, 1, 2))
