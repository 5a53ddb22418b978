"""U-Net generator (counterpart of gan_tpu/models/unet.py).

At 256²: 8 downsample blocks (64, 128, 256, 512×5; the first without norm) to
a 1×1×512 bottleneck, 7 upsample blocks (512×3 with dropout, 512, 256, 128,
64) each followed by ``cat([up(x), skip])``, and a final stride-2 transposed
conv with bias to ``out_channels`` + tanh in fp32. ``depth`` cuts the stack
for small test images, keeping the tail of the up specs as gan_tpu does.

Submodules are named ``down_i``, ``up_i`` and ``last`` as in gan_tpu's
parameter pytree (see gan_tpu_torch.transplant). Input and output are NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gan_tpu_torch.models.blocks import Downsample, Upsample, conv_kernel_init
from gan_tpu_torch.ops.conv import conv2d_transpose_up

_DOWN_FILTERS = (64, 128, 256, 512, 512, 512, 512, 512)
# (filters, apply_dropout) per up block
_UP_SPECS = ((512, True), (512, True), (512, True), (512, False),
             (256, False), (128, False), (64, False))


class Head(nn.Module):
    """Final stride-2 transposed conv with bias (N(0, 0.02) kernel, zero bias)."""

    def __init__(self, c_in: int, c_out: int, generator: torch.Generator | None):
        super().__init__()
        self.conv = conv_kernel_init((c_in, c_out, 4, 4), generator)
        self.bias = nn.Parameter(torch.zeros(c_out))


class UNetGenerator(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *, norm: str = "batch",
                 depth: int = 8, generator: torch.Generator | None = None):
        super().__init__()
        self.depth = depth
        self.down_filters = _DOWN_FILTERS[:depth]
        # keep the *last* depth-1 up specs so the tail (…256, 128, 64) is preserved
        self.up_specs = _UP_SPECS[len(_UP_SPECS) - (depth - 1):]
        c = in_channels
        for i, f in enumerate(self.down_filters):
            self.add_module(f"down_{i}", Downsample(c, f, norm=norm, apply_norm=(i != 0),
                                                    generator=generator))
            c = f
        skip_channels = list(self.down_filters[:-1])[::-1]  # skips, deepest first
        for i, (f, _drop) in enumerate(self.up_specs):
            self.add_module(f"up_{i}", Upsample(c, f, norm=norm, generator=generator))
            c = f + skip_channels[i]
        self.last = Head(c, out_channels, generator)
        # conv weights in channels-last memory, the layout cuDNN's NHWC kernels
        # read: the per-call dtype cast then yields it, and no relayout copy runs
        self.to(memory_format=torch.channels_last)

    @property
    def n_dropout(self) -> int:
        """Dropout sites per forward pass (the masks ``forward`` consumes)."""
        return sum(drop for _f, drop in self.up_specs)

    def forward(self, x, *, generator: torch.Generator | None = None,
                masks: Sequence[torch.Tensor] | None = None, compute_dtype=None):
        """x: (N, H, W, C_in) -> (N, H, W, out_channels) fp32 in [-1, 1].

        Dropout draws from ``generator``, or takes ``masks`` (one keep-mask per
        dropout site, in call order); with neither it is off."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        skips = []
        h = x
        for i in range(self.depth):
            h = getattr(self, f"down_{i}")(h, compute_dtype=compute_dtype)
            skips.append(h)
        skips = skips[:-1][::-1]

        mask_iter = iter(masks) if masks is not None else None
        for i, (_f, use_drop) in enumerate(self.up_specs):
            mask = next(mask_iter) if use_drop and mask_iter is not None else None
            h = getattr(self, f"up_{i}")(h, compute_dtype=compute_dtype, drop_mask=mask,
                                         drop_generator=generator if use_drop else None)
            h = torch.cat([h, skips[i]], dim=-1)

        out = conv2d_transpose_up(h, self.last.conv, compute_dtype=compute_dtype)
        out = out + self.last.bias.to(out.dtype)
        return torch.tanh(out.float())
