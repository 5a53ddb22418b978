"""pix2pixHD's discriminators (NVIDIA/pix2pixHD models/networks.py
``NLayerDiscriminator`` with ``getIntermFeat`` and ``MultiscaleDiscriminator``),
on NHWC activations.

One n-layer discriminator (``n_layers`` 3, ``ndf`` 64):

    Conv 4x4 s2 p2 to ndf → LeakyReLU(0.2)
    n_layers − 1 × [Conv 4x4 s2 p2 to twice the channels (≤ 512) → IN → LeakyReLU(0.2)]
    Conv 4x4 s1 p2 to twice the channels (≤ 512) → IN → LeakyReLU(0.2)
    Conv 4x4 s1 p2 to 1

returning every layer's output (the features that feature matching reads,
then the patch scores, in fp32). IN is the affine-free instance norm of
``models.resnet_generator``. The two-scale discriminator is ``num_D`` such
networks; network i sees the input average-pooled i times (3x3, stride 2,
padding 1, the pad left out of the mean): ``multiscale`` below. NVIDIA's
wrapper names the full-resolution network ``scale{num_D-1}``; here it is
network 0. Parameter names: ``layer_{k}.weight`` and ``.bias``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gan_tpu_torch.models.resnet_generator import AffineFreeNorm, ConvParams
from gan_tpu_torch.ops.conv import avg_pool3_s2, conv2d_pad

LEAKY_SLOPE = 0.2


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_channels: int, *, ndf: int = 64, n_layers: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.strides = []
        c = in_channels
        for k in range(n_layers + 1):
            out = min(ndf << k, 512)
            self.add_module(f"layer_{k}", ConvParams(c, out, 4, generator))
            if k:
                self.add_module(f"norm_{k}", AffineFreeNorm(out))
            self.strides.append(2 if k < n_layers else 1)
            c = out
        self.add_module(f"layer_{n_layers + 1}", ConvParams(c, 1, 4, generator))
        self.strides.append(1)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, compute_dtype=None) -> list[torch.Tensor]:
        """x: (N, H, W, C) → [each layer's output]; the last, the patch
        scores, in fp32."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        outs, h = [], x
        last = len(self.strides) - 1
        for k, stride in enumerate(self.strides):
            conv = getattr(self, f"layer_{k}")
            h = conv2d_pad(h, conv.weight, conv.bias, stride=stride, pad=2,
                           compute_dtype=compute_dtype)
            if 0 < k < last:
                h = F.leaky_relu(getattr(self, f"norm_{k}")(h), LEAKY_SLOPE)
            elif k == 0:
                h = F.leaky_relu(h, LEAKY_SLOPE)
            outs.append(h)
        outs[-1] = outs[-1].float()
        return outs


def multiscale(discriminators, x, *, compute_dtype=None) -> list[list[torch.Tensor]]:
    """``MultiscaleDiscriminator.forward``: network i on ``x`` pooled i times."""
    out = []
    for i, d in enumerate(discriminators):
        if i:
            x = avg_pool3_s2(x)
        out.append(d(x, compute_dtype=compute_dtype))
    return out
