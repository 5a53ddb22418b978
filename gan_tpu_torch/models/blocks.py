"""Down/up-sample blocks of the U-Net (counterpart of gan_tpu/models/blocks.py).

TF-parity semantics, as in gan_tpu:

* Downsample: Conv(k4 s2 'same', no bias) -> [norm] -> LeakyReLU(0.3);
* Upsample: ConvT(k4 s2 'same', no bias) -> norm -> [Dropout(0.5)] -> ReLU;
* every conv kernel N(0, 0.02); instance-norm scale N(1, 0.02), offset 0;
* dropout is inverted dropout and stays on at inference (the reference calls
  every model with ``training=True``).

Parameter names follow gan_tpu's pytree (``conv``, ``norm.scale``,
``norm.offset``) so a state_dict key is the pytree path joined by dots.
Only instance norm (CycleGAN) is ported; batch norm comes with Pix2Pix.
"""

from __future__ import annotations

import torch
from torch import nn

from gan_tpu_torch.ops.conv import conv2d_down, conv2d_transpose_up
from gan_tpu_torch.ops.kernels import instance_norm
from gan_tpu_torch.ops.norm import activation

DROP_RATE = 0.5


def conv_kernel_init(shape, generator: torch.Generator | None, stddev: float = 0.02):
    """N(0, 0.02) initializer used for every conv in the reference."""
    return nn.Parameter(stddev * torch.randn(shape, generator=generator))


def dropout(x, rate: float, *, generator: torch.Generator | None = None,
            mask: torch.Tensor | None = None):
    """Inverted dropout (TF semantics). ``mask`` (True = keep) is used as
    given; otherwise it is drawn from ``generator``; with neither it is a
    no-op."""
    if mask is None:
        if generator is None:
            return x
        mask = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(mask.to(x.device), x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))


class InstanceNorm(nn.Module):
    """Per-sample (H, W) normalization with per-channel scale/offset; runs the
    CUDA kernel on a CUDA tensor, the plain version on a CPU one."""

    def __init__(self, c: int, generator: torch.Generator | None):
        super().__init__()
        self.scale = nn.Parameter(1.0 + 0.02 * torch.randn(c, generator=generator))
        self.offset = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return instance_norm(x, self.scale, self.offset)


def norm_layer(norm: str, c: int, generator):
    if norm == "instance":
        return InstanceNorm(c, generator)
    if norm == "batch":
        raise NotImplementedError("batch norm (the Pix2Pix generator) is not ported yet")
    raise ValueError(f"unknown norm {norm!r}")


class Downsample(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, norm: str, apply_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = conv_kernel_init((c_out, c_in, 4, 4), generator)
        self.norm = norm_layer(norm, c_out, generator) if apply_norm else None

    def forward(self, x, *, compute_dtype=None):
        x = conv2d_down(x, self.conv, compute_dtype=compute_dtype)
        if self.norm is not None:
            x = self.norm(x)
        return activation(x, "leaky_relu")


class Upsample(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, norm: str,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = conv_kernel_init((c_in, c_out, 4, 4), generator)
        self.norm = norm_layer(norm, c_out, generator)

    def forward(self, x, *, compute_dtype=None, drop_generator=None, drop_mask=None):
        x = conv2d_transpose_up(x, self.conv, compute_dtype=compute_dtype)
        x = self.norm(x)
        x = dropout(x, DROP_RATE, generator=drop_generator, mask=drop_mask)
        return activation(x, "relu")
