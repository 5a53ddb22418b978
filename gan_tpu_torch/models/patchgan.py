"""70×70 PatchGAN discriminator, CycleGAN's unconditional form (counterpart of
gan_tpu/models/patchgan.py with ``target=False``).

    downsample 64 (no norm) → 128 → 256
    ZeroPad(1) → Conv 512 k4 s1 VALID, no bias → norm → LeakyReLU(0.3)
    ZeroPad(1) → Conv 1 k4 s1 VALID with bias

A 256² input gives 30×30 logits, in fp32; the 512-channel norm sits at 31².
Parameter names are gan_tpu's (``down_0..2``, ``conv512``, ``norm512``,
``last.conv``, ``last.bias``), so gan_tpu_torch.transplant converts them as it
does the U-Net's. Conv weights are OIHW, kept in channels-last memory as the
U-Net's are. The conditional (Pix2Pix) form and batch norm come with Pix2Pix.
"""

from __future__ import annotations

import torch
from torch import nn

from gan_tpu_torch.models.blocks import Downsample, conv_kernel_init, norm_layer
from gan_tpu_torch.ops.conv import conv2d_valid
from gan_tpu_torch.ops.norm import activation


class _Last(nn.Module):
    """Final 4×4 conv to one channel, with bias (N(0, 0.02) kernel, zero bias)."""

    def __init__(self, c_in: int, generator: torch.Generator | None):
        super().__init__()
        self.conv = conv_kernel_init((1, c_in, 4, 4), generator)
        self.bias = nn.Parameter(torch.zeros(1))


class PatchGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int, *, norm: str = "instance",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.down_0 = Downsample(in_channels, 64, norm=norm, apply_norm=False,
                                 generator=generator)
        self.down_1 = Downsample(64, 128, norm=norm, generator=generator)
        self.down_2 = Downsample(128, 256, norm=norm, generator=generator)
        self.conv512 = conv_kernel_init((512, 256, 4, 4), generator)
        self.norm512 = norm_layer(norm, 512, generator)
        self.last = _Last(512, generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, compute_dtype=None):
        """x: (N, H, W, C_in) → patch logits (N, H/8 − 2, W/8 − 2, 1) in fp32."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        h = self.down_0(x, compute_dtype=compute_dtype)
        h = self.down_1(h, compute_dtype=compute_dtype)
        h = self.down_2(h, compute_dtype=compute_dtype)
        h = conv2d_valid(h, self.conv512, pad=1, compute_dtype=compute_dtype)
        h = activation(self.norm512(h), "leaky_relu")
        h = conv2d_valid(h, self.last.conv, pad=1, compute_dtype=compute_dtype)
        return (h + self.last.bias.to(h.dtype)).float()
