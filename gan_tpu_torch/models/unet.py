"""U-Net generator (counterpart of gan_tpu/models/unet.py), with instance norm
(CycleGAN) or batch norm (Pix2Pix).

At 256²: 8 downsample blocks (64, 128, 256, 512×5; the first without norm) to
a 1×1×512 bottleneck, 7 upsample blocks (512×3 with dropout, 512, 256, 128,
64) each followed by ``cat([up(x), skip])``, and a final stride-2 transposed
conv with bias to ``out_channels`` + tanh in fp32. ``depth`` cuts the stack
for small test images, keeping the tail of the up specs as gan_tpu does.

Submodules are named ``down_i``, ``up_i`` and ``last`` as in gan_tpu's
parameter pytree (see gan_tpu_torch.transplant). Input and output are NHWC.

``remat`` (``--remat``, gan_tpu's ``jax.checkpoint`` of each block) runs
every down and up block, the stem included, through non-reentrant
``torch.utils.checkpoint`` while autograd records: a block keeps only its
input and output, and the backward recomputes the rest (its conv, S, K1).
The head is not wrapped, as in gan_tpu.

``bn_group`` (gan_tpu's ``bn_axis_name``) reaches every batch norm: the
process group whose replicas' moments it all-reduces, or None. Dropout masks are drawn before any
block runs, so a recomputed block reads the mask its forward read; a mask
drawn inside the block would be drawn again, and differ, since
``preserve_rng_state`` does not restore an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from gan_tpu_torch.models import blocks
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
                 depth: int = 8, generator: torch.Generator | None = None,
                 remat: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
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

    def dropout_shapes(self, batch: int, size: int) -> list[tuple[int, int, int, int]]:
        """The NHWC shape of each dropout site's mask, in call order, for a
        (batch, size, size, C) input: up block i works at size / 2^(depth-1-i)."""
        return [(batch, size >> (self.depth - 1 - i), size >> (self.depth - 1 - i), f)
                for i, (f, drop) in enumerate(self.up_specs) if drop]

    def forward(self, x, *, generator: torch.Generator | None = None,
                masks: Sequence[torch.Tensor] | None = None, compute_dtype=None,
                per_sample: bool = False, bn_group=None):
        """x: (N, H, W, C_in) -> (N, H, W, out_channels) fp32 in [-1, 1].

        Dropout takes ``masks`` (one keep-mask per dropout site, in call
        order), or draws them from ``generator`` before the first block, in
        that order; with neither it is off. ``per_sample`` gives batch norm
        each image's own statistics (predict); instance norm has them
        anyway."""
        if masks is None and generator is not None:
            masks = [blocks.keep_mask(shape, generator, x.device)
                     for shape in self.dropout_shapes(x.shape[0], x.shape[1])]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        remat = self.remat and torch.is_grad_enabled()

        def block(name, h, **kwargs):
            module = getattr(self, name)
            if remat:   # no global RNG state to keep: the step draws from none
                return checkpoint(module, h, use_reentrant=False, preserve_rng_state=False,
                                  compute_dtype=compute_dtype, per_sample=per_sample,
                                  bn_group=bn_group, **kwargs)
            return module(h, compute_dtype=compute_dtype, per_sample=per_sample,
                          bn_group=bn_group, **kwargs)

        skips = []
        h = x
        for i in range(self.depth):
            h = block(f"down_{i}", h)
            skips.append(h)
        skips = skips[:-1][::-1]

        mask_iter = iter(masks) if masks is not None else None
        for i, (_f, use_drop) in enumerate(self.up_specs):
            mask = next(mask_iter) if use_drop and mask_iter is not None else None
            h = block(f"up_{i}", h, drop_mask=mask)
            h = torch.cat([h, skips[i]], dim=-1)

        out = conv2d_transpose_up(h, self.last.conv, compute_dtype=compute_dtype)
        out = out + self.last.bias.to(out.dtype)
        return torch.tanh(out.float())
