"""Down/up-sample blocks of the U-Net (counterpart of gan_tpu/models/blocks.py).

TF-parity semantics, as in gan_tpu:

* Downsample: Conv(k4 s2 'same', no bias) -> [norm] -> LeakyReLU(0.3); the
  stem (the first block, without a norm) runs conv and LeakyReLU as one
  kernel, S (``kernels.stem_conv``);
* Upsample: ConvT(k4 s2 'same', no bias) -> norm -> [Dropout(0.5)] -> ReLU;
* every conv kernel N(0, 0.02); instance-norm scale N(1, 0.02), offset 0;
  batch-norm gamma 1, beta 0 (Keras' defaults);
* dropout is inverted dropout and stays on at inference (the reference calls
  every model with ``training=True``), and so do batch statistics.

Parameter names follow gan_tpu's pytree (``conv``, ``norm.scale``,
``norm.offset``, ``norm.gamma``, ``norm.beta``) so a state_dict key is the
pytree path joined by dots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gan_tpu_torch.ops.conv import conv2d_down, conv2d_transpose_up
from gan_tpu_torch.ops.kernels import instance_norm, stem_conv
from gan_tpu_torch.ops.norm import BN_EPS, activation, batch_norm

DROP_RATE = 0.5


def conv_kernel_init(shape, generator: torch.Generator | None, stddev: float = 0.02):
    """N(0, 0.02) initializer used for every conv in the reference."""
    return nn.Parameter(stddev * torch.randn(shape, generator=generator))


def keep_mask(shape, generator: torch.Generator | None, device, rate: float = DROP_RATE):
    """Inverted dropout's keep-mask (True = keep): a uniform draw from
    ``generator`` below 1 − rate."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x, rate: float, mask: torch.Tensor | None = None):
    """Inverted dropout (TF semantics) with the keep-mask ``mask`` (True =
    keep, from :func:`keep_mask`); without one it is a no-op."""
    if mask is None:
        return x
    return torch.where(mask.to(x.device), x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))


class InstanceNorm(nn.Module):
    """Per-sample (H, W) normalization with per-channel scale/offset; runs the
    CUDA kernel on a CUDA tensor, the plain version on a CPU one.
    ``per_sample`` changes nothing: instance norm is per sample already."""

    def __init__(self, c: int, generator: torch.Generator | None):
        super().__init__()
        self.scale = nn.Parameter(1.0 + 0.02 * torch.randn(c, generator=generator))
        self.offset = nn.Parameter(torch.zeros(c))

    def forward(self, x, *, per_sample: bool = False, group=None):
        """``group`` changes nothing either: instance norm has no
        cross-replica form."""
        return instance_norm(x, self.scale, self.offset)


class BatchNorm(nn.Module):
    """Batch statistics over (N, H, W), epsilon 1e-3, no running statistics.

    ``per_sample`` normalises each image with its own statistics, as the
    reference's one-image-at-a-time predict does (gan_tpu vmaps the generator
    over batch-1 sub-batches): batch norm over (1, H, W) is instance norm
    over (H, W) with batch norm's epsilon, so it runs K1. A batch of one is
    the same case. Otherwise the statistics span the batch: on the card
    through ``F.batch_norm`` (XLA's in gan_tpu, no Pallas kernel), on the CPU
    through the plain version.

    ``group`` (cross-replica batch norm, ``--bn-cross-replica true`` over
    several replicas) takes the statistics over every replica's batch
    through the plain version's all-reduced moments, whatever the
    replica's batch: at a batch of one they span W images, so that case is
    no instance norm then. Per-replica statistics (no group) are each
    replica's own batch's, so a replica's batch of one runs K1."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x, *, per_sample: bool = False, group=None):
        if group is not None:
            return batch_norm(x, self.gamma, self.beta, group=group)
        if per_sample or x.shape[0] == 1:
            return instance_norm(x, self.gamma, self.beta, eps=BN_EPS)
        if x.device.type == "cuda":
            y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, self.gamma, self.beta,
                             training=True, eps=BN_EPS)
            return y.permute(0, 2, 3, 1).contiguous()
        return batch_norm(x, self.gamma, self.beta)


def norm_layer(norm: str, c: int, generator):
    if norm == "instance":
        return InstanceNorm(c, generator)
    if norm == "batch":
        return BatchNorm(c)
    raise ValueError(f"unknown norm {norm!r}")


class Downsample(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, norm: str, apply_norm: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = conv_kernel_init((c_out, c_in, 4, 4), generator)
        self.norm = norm_layer(norm, c_out, generator) if apply_norm else None

    def forward(self, x, *, compute_dtype=None, per_sample: bool = False, bn_group=None):
        if self.norm is None:   # the stem: conv and LeakyReLU in one kernel
            return stem_conv(x, self.conv, compute_dtype=compute_dtype)
        x = conv2d_down(x, self.conv, compute_dtype=compute_dtype)
        return activation(self.norm(x, per_sample=per_sample, group=bn_group), "leaky_relu")


class Upsample(nn.Module):
    def __init__(self, c_in: int, c_out: int, *, norm: str,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = conv_kernel_init((c_in, c_out, 4, 4), generator)
        self.norm = norm_layer(norm, c_out, generator)

    def forward(self, x, *, compute_dtype=None, drop_mask=None, per_sample: bool = False,
                bn_group=None):
        x = conv2d_transpose_up(x, self.conv, compute_dtype=compute_dtype)
        x = self.norm(x, per_sample=per_sample, group=bn_group)
        x = dropout(x, DROP_RATE, mask=drop_mask)
        return activation(x, "relu")
