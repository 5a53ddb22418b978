"""pix2pixHD's global generator (NVIDIA/pix2pixHD models/networks.py
``GlobalGenerator`` and ``ResnetBlock``, ``--netG global``), on NHWC
activations:

    ReflectionPad(3) → Conv 7x7 in→ngf → IN → ReLU
    n_down × [Conv 3x3 s2 p1 to twice the channels → IN → ReLU]
    n_blocks × ResnetBlock at ngf·2^n_down channels:
        x + [ReflectionPad(1) → Conv 3x3 → IN → ReLU → ReflectionPad(1) → Conv 3x3 → IN](x)
    n_down × [ConvTranspose 3x3 s2 p1 op1 to half the channels → IN → ReLU]
    ReflectionPad(3) → Conv 7x7 ngf→out → tanh

IN is ``InstanceNorm2d(affine=False)``, eps 1e-5: the kernels K1 and K2
(``ops.kernels.instance_norm``) with a constant scale of ones and offset of
zeros, which take no gradient. Every conv has a bias, also those before a
norm, as published (their gradient is zero in exact arithmetic). Weights
are N(0, 0.02) (pix2pixHD's ``weights_init``), biases PyTorch's default
U(±1/√fan_in). Parameter names: ``stem``, ``down_{i}``,
``block_{j}.conv_{0,1}``, ``up_{i}``, ``head``, each ``.weight`` and
``.bias``; conv weights OIHW, transposed ones (C_in, C_out, k, k), held in
channels-last memory as the U-Net's are.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gan_tpu_torch.ops.conv import conv2d_pad, conv_transpose2d, reflection_pad
from gan_tpu_torch.ops.kernels import instance_norm


class ConvParams(nn.Module):
    """A conv's weight, N(0, 0.02), and its bias, U(±1/√fan_in) as
    ``nn.Conv2d`` draws it. ``transposed``: the weight is (C_in, C_out, k, k)."""

    def __init__(self, c_in: int, c_out: int, k: int, generator: torch.Generator | None, *,
                 transposed: bool = False):
        super().__init__()
        shape = (c_in, c_out, k, k) if transposed else (c_out, c_in, k, k)
        self.weight = nn.Parameter(0.02 * torch.randn(shape, generator=generator))
        # nn.ConvTranspose2d's fan_in is weight.size(1) · k², its C_out
        bound = 1.0 / math.sqrt(shape[1] * k * k)
        self.bias = nn.Parameter((2 * torch.rand(c_out, generator=generator) - 1) * bound)


class AffineFreeNorm(nn.Module):
    """``InstanceNorm2d(affine=False)``: K1/K2 with constant ones and zeros
    (buffers, not saved with the parameters)."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("ones", torch.ones(c), persistent=False)
        self.register_buffer("zeros", torch.zeros(c), persistent=False)

    def forward(self, x):
        return instance_norm(x, self.ones, self.zeros)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, generator: torch.Generator | None):
        super().__init__()
        self.conv_0 = ConvParams(dim, dim, 3, generator)
        self.conv_1 = ConvParams(dim, dim, 3, generator)
        self.norm = AffineFreeNorm(dim)

    def forward(self, x, compute_dtype=None):
        h = conv2d_pad(reflection_pad(x, 1), self.conv_0.weight, self.conv_0.bias,
                       compute_dtype=compute_dtype)
        h = torch.relu(self.norm(h))
        h = conv2d_pad(reflection_pad(h, 1), self.conv_1.weight, self.conv_1.bias,
                       compute_dtype=compute_dtype)
        return x + self.norm(h)


class GlobalGenerator(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 3, *, ngf: int = 64,
                 n_downsample: int = 4, n_blocks: int = 9,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_downsample, self.n_blocks = n_downsample, n_blocks
        self.stem = ConvParams(in_channels, ngf, 7, generator)
        self.stem_norm = AffineFreeNorm(ngf)
        for i in range(n_downsample):
            c = ngf << i
            self.add_module(f"down_{i}", ConvParams(c, 2 * c, 3, generator))
            self.add_module(f"down_{i}_norm", AffineFreeNorm(2 * c))
        for j in range(n_blocks):
            self.add_module(f"block_{j}", ResnetBlock(ngf << n_downsample, generator))
        for i in range(n_downsample):
            c = ngf << (n_downsample - i)
            self.add_module(f"up_{i}", ConvParams(c, c // 2, 3, generator, transposed=True))
            self.add_module(f"up_{i}_norm", AffineFreeNorm(c // 2))
        self.head = ConvParams(ngf, out_channels, 7, generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, compute_dtype=None):
        """x: (N, H, W, C_in), H and W multiples of 2^n_downsample → (N, H,
        W, C_out) in [-1, 1], in ``compute_dtype``."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        h = conv2d_pad(reflection_pad(x, 3), self.stem.weight, self.stem.bias,
                       compute_dtype=compute_dtype)
        h = torch.relu(self.stem_norm(h))
        for i in range(self.n_downsample):
            conv = getattr(self, f"down_{i}")
            h = conv2d_pad(h, conv.weight, conv.bias, stride=2, pad=1,
                           compute_dtype=compute_dtype)
            h = torch.relu(getattr(self, f"down_{i}_norm")(h))
        for j in range(self.n_blocks):
            h = getattr(self, f"block_{j}")(h, compute_dtype)
        for i in range(self.n_downsample):
            conv = getattr(self, f"up_{i}")
            h = conv_transpose2d(h, conv.weight, conv.bias, compute_dtype=compute_dtype)
            h = torch.relu(getattr(self, f"up_{i}_norm")(h))
        h = conv2d_pad(reflection_pad(h, 3), self.head.weight, self.head.bias,
                       compute_dtype=compute_dtype)
        return torch.tanh(h)
