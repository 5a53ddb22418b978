"""Instance and batch normalization, plain PyTorch (counterpart of gan_tpu/ops/norm.py).

Instance norm: per-sample, per-channel moments over (H, W) of an NHWC tensor,
epsilon 1e-5, two-pass variance E[(x - mean)^2] in fp32; the output is cast
back to the input dtype so bf16 activations stay bf16. ``act`` is the
activation epilogue that the fused kernel carries
(gan_tpu/ops/pallas_kernels.py:95-98).

Batch norm (Pix2Pix): moments over (N, H, W) per channel, Keras' epsilon
1e-3, the same fp32 two-pass form, and no running statistics: the reference
calls every network in training mode, so batch statistics are always used.
Over data-parallel replicas the statistics are each replica's own by
default; with a process group (``--bn-cross-replica true``) the moments span
every replica's batch: the fp32 mean all-reduced, then the variance about
it, two ``all_reduce`` calls per site with autograd through them (gan_tpu's
``pmean`` of the moments), so the two-pass form stays.

This is the reference the CUDA kernels (gan_tpu_torch/ops/kernels.py) are
held against, and the version a CPU tensor runs: on the CPU autograd takes
the gradient of :func:`instance_norm`, and :func:`instance_norm_backward`
writes that gradient out as the backward kernel (K2) computes it.
"""

from __future__ import annotations

import torch

from gan_tpu_torch.parallel.mesh import replica_mean

IN_EPS = 1e-5       # reference InstanceNormalization epsilon
BN_EPS = 1e-3       # Keras BatchNormalization default
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


def _normalize(x, scale, offset, dims, eps):
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + offset.float()


def instance_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, *,
                  act: str | None = None, eps: float = IN_EPS) -> torch.Tensor:
    """x: (N, H, W, C); scale, offset: (C,)."""
    return activation(_normalize(x, scale, offset, (1, 2), eps), act).to(x.dtype)


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               eps: float = BN_EPS, group=None) -> torch.Tensor:
    """x: (N, H, W, C); gamma, beta: (C,). Statistics over the whole batch,
    or with ``group`` (a process group of replicas whose batches are of one
    size) over every replica's batch."""
    if group is None:
        return _normalize(x, gamma, beta, (0, 1, 2), eps).to(x.dtype)
    xf = x.float()
    mean = replica_mean(xf.mean(dim=(0, 1, 2), keepdim=True), group)
    var = replica_mean((xf - mean).square().mean(dim=(0, 1, 2), keepdim=True), group)
    return ((xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(x.dtype)


def instance_norm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                           eps: float = IN_EPS):
    """The VJP of :func:`instance_norm` with ``act=None``, in the explicit form
    of gan_tpu/ops/pallas_kernels.py:_in_bwd_kernel, in fp32: with
    x̂ = (x − mean)·inv, dx = inv·(dy·γ − mean(dy·γ) − x̂·mean(dy·γ·x̂)),
    dγ = Σ dy·x̂ and dβ = Σ dy over (N, H, W). Returns (dx in x's dtype,
    dscale, doffset in fp32)."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt((xf - mean).square().mean(dim=(1, 2), keepdim=True) + eps)
    xhat = (xf - mean) * inv
    dyg = dyf * scale.float()
    m1 = dyg.mean(dim=(1, 2), keepdim=True)
    m2 = (dyg * xhat).mean(dim=(1, 2), keepdim=True)
    dx = inv * (dyg - m1 - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=(0, 1, 2)), dyf.sum(dim=(0, 1, 2))
