"""The reference's networks in plain PyTorch, float32: the U-Net generator and
the 70x70 PatchGAN discriminator of kingjosephm/GAN, as the configuration
files under ``portbench/configs`` state them.

Activations are NHWC at the networks' boundaries, as the program's are, so
the dropout keep-masks that both sides draw have one layout. Parameters
carry the program's names and layouts (a conv weight is OIHW, a transposed
conv weight (C_in, C_out, k, k)), so that one set of seeded weights loads
into both. Nothing here initialises a weight: the benchmark makes them.

``q`` is applied to both operands of every convolution, and ``q.grad``,
where it has one, to the gradient of every convolution's output. It is the
identity for the reference; the control (``portbench.reference.steps.fp8``)
rounds them to float8 with a per-tensor scale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.3   # tf.keras LeakyReLU's alpha
IN_EPS = 1e-5       # the reference's InstanceNormalization
BN_EPS = 1e-3       # Keras' BatchNormalization
DROP_RATE = 0.5


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def leaky(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _out(y, q):
    return _nhwc(q.grad(y) if hasattr(q, "grad") else y)


def conv_down(x, w, q):
    """4x4 stride-2 'same' conv (TF padding is 1 on each side at even sizes)."""
    return _out(F.conv2d(_nchw(q(x)), q(w), stride=2, padding=1), q)


def conv_up(x, w, q):
    """4x4 stride-2 'same' transposed conv: output twice the input's size."""
    return _out(F.conv_transpose2d(_nchw(q(x)), q(w), stride=2, padding=1), q)


def conv_pad1(x, w, q):
    """ZeroPadding2D(1) then a 4x4 stride-1 'valid' conv."""
    return _out(F.conv2d(_nchw(q(x)), q(w), stride=1, padding=1), q)


class Norm(nn.Module):
    """Instance norm (per sample over H, W; scale and offset) or batch norm
    (over N, H, W with batch statistics; gamma and beta), two-pass in fp32."""

    def __init__(self, kind: str, c: int):
        super().__init__()
        self.kind = kind
        if kind == "instance":
            self.scale, self.offset = nn.Parameter(torch.empty(c)), nn.Parameter(torch.empty(c))
        elif kind == "batch":
            self.gamma, self.beta = nn.Parameter(torch.empty(c)), nn.Parameter(torch.empty(c))
        else:
            raise ValueError(f"unknown norm {kind!r}")

    def forward(self, x):
        if self.kind == "instance":
            dims, eps, a, b = (1, 2), IN_EPS, self.scale, self.offset
        else:
            dims, eps, a, b = (0, 1, 2), BN_EPS, self.gamma, self.beta
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * a + b


class Down(nn.Module):
    def __init__(self, c_in: int, c_out: int, norm):
        super().__init__()
        self.conv = nn.Parameter(torch.empty(c_out, c_in, 4, 4))
        self.norm = Norm(norm, c_out) if norm else None

    def forward(self, x, q):
        h = conv_down(x, self.conv, q)
        return leaky(h if self.norm is None else self.norm(h))


class Up(nn.Module):
    def __init__(self, c_in: int, c_out: int, norm: str):
        super().__init__()
        self.conv = nn.Parameter(torch.empty(c_in, c_out, 4, 4))
        self.norm = Norm(norm, c_out)

    def forward(self, x, q, mask=None):
        h = self.norm(conv_up(x, self.conv, q))
        if mask is not None:
            h = torch.where(mask, h / (1.0 - DROP_RATE), torch.zeros_like(h))
        return torch.relu(h)


class UNet(nn.Module):
    """Down blocks (the first without a norm) to a 1x1 bottleneck, up blocks
    each followed by ``cat([up, skip])``, and a stride-2 transposed conv
    with bias to the output channels, then tanh. At ``depth`` below 8 the
    down filters keep their head and the up blocks their tail."""

    def __init__(self, channels: int, norm: str, depth: int, down_filters, up_blocks):
        super().__init__()
        self.depth = depth
        self.down_filters = list(down_filters)[:depth]
        self.up_blocks = [tuple(u) for u in up_blocks][len(up_blocks) - (depth - 1):]
        c = channels
        for i, f in enumerate(self.down_filters):
            self.add_module(f"down_{i}", Down(c, f, norm if i else None))
            c = f
        skips = self.down_filters[:-1][::-1]
        for i, (f, _drop) in enumerate(self.up_blocks):
            self.add_module(f"up_{i}", Up(c, f, norm))
            c = f + skips[i]
        self.last = nn.Module()
        self.last.conv = nn.Parameter(torch.empty(c, channels, 4, 4))
        self.last.bias = nn.Parameter(torch.empty(channels))

    def dropout_shapes(self, batch: int, size: int) -> list[tuple]:
        """The NHWC shape of each dropout site's keep-mask, in call order."""
        return [(batch, size >> (self.depth - 1 - i), size >> (self.depth - 1 - i), f)
                for i, (f, drop) in enumerate(self.up_blocks) if drop]

    def forward(self, x, masks=None, q=identity):
        skips, h = [], x
        for i in range(self.depth):
            h = getattr(self, f"down_{i}")(h, q)
            skips.append(h)
        skips = skips[:-1][::-1]
        masks = iter(masks or ())
        for i, (_f, drop) in enumerate(self.up_blocks):
            h = getattr(self, f"up_{i}")(h, q, next(masks, None) if drop else None)
            h = torch.cat([h, skips[i]], dim=-1)
        return torch.tanh(conv_up(h, self.last.conv, q) + self.last.bias)


class PatchGAN(nn.Module):
    """[cat(input, target)] -> down 64 (no norm) -> 128 -> 256 -> pad, conv
    512, norm, LeakyReLU -> pad, conv 1 with bias: patch logits."""

    def __init__(self, channels: int, norm: str, conditional: bool):
        super().__init__()
        self.conditional = conditional
        c = 2 * channels if conditional else channels
        self.down_0 = Down(c, 64, None)
        self.down_1 = Down(64, 128, norm)
        self.down_2 = Down(128, 256, norm)
        self.conv512 = nn.Parameter(torch.empty(512, 256, 4, 4))
        self.norm512 = Norm(norm, 512)
        self.last = nn.Module()
        self.last.conv = nn.Parameter(torch.empty(1, 512, 4, 4))
        self.last.bias = nn.Parameter(torch.empty(1))

    def forward(self, x, y=None, q=identity):
        if self.conditional:
            x = torch.cat([x, y], dim=-1)
        h = self.down_2(self.down_1(self.down_0(x, q), q), q)
        h = leaky(self.norm512(conv_pad1(h, self.conv512, q)))
        return conv_pad1(h, self.last.conv, q) + self.last.bias


def generator_depth(img_size: int, depth: int) -> int:
    """The configuration's depth, capped at log2 of the image size for small
    test images, as the program caps it."""
    return min(depth, img_size.bit_length() - 1)
