"""On-device augmentation (counterpart of gan_tpu/data/augment.py).

* ``normalize_batch``: the deterministic val/test/predict path, x/127.5 − 1.
* ``single_jitter_batch``: CycleGAN's ``random_jitter``: an independent
  random crop of each (S+30)² image to S², a 50% left-right mirror per image,
  then normalize. ``crop_flip_normalize`` does the crop for given draws, so
  a test can hand both packages the same offsets.

gan_tpu expresses the crop as one-hot selector matmuls, a TPU matrix-unit
trick; here it is a gather on the device. Both select exactly, so the
outputs are equal for equal draws. The draws come from a ``torch.Generator``
on the batch's device, so they match gan_tpu's in distribution only.
"""

from __future__ import annotations

import torch

JITTER_PAD = 30  # the reference resizes to img_size + 30 before the crop


def normalize_batch(batch_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8-valued -> [-1, 1] in ``dtype``, on the tensor's device: x/127.5 - 1."""
    return batch_u8.to(dtype) / 127.5 - 1.0


def crop_flip_normalize(batch_u8: torch.Tensor, oh: torch.Tensor, ow: torch.Tensor,
                        flip: torch.Tensor, *, img_size: int, dtype=torch.float32):
    """out[b, i, k] = x[b, oh[b] + i, ow[b] + (img_size − 1 − k if flip[b] else k)],
    normalized. batch_u8: (B, S', S', C); oh, ow: (B,) integer; flip: (B,) bool."""
    i = torch.arange(img_size, device=batch_u8.device)
    rows = oh[:, None] + i                                               # (B, S)
    cols = ow[:, None] + torch.where(flip[:, None], img_size - 1 - i, i)  # (B, S)
    b = torch.arange(batch_u8.shape[0], device=batch_u8.device)
    out = batch_u8[b[:, None, None], rows[:, :, None], cols[:, None, :]]
    return normalize_batch(out, dtype)


def single_jitter_batch(batch_u8: torch.Tensor, generator: torch.Generator | None, *,
                        img_size: int, dtype=torch.float32) -> torch.Tensor:
    """Independent crop + mirror + normalize. batch_u8: (B, S+30, S+30, C) uint8
    on the generator's device; crop offsets uniform in [0, S'−S], mirror when a
    uniform draw exceeds 0.5."""
    b, src = batch_u8.shape[0], batch_u8.shape[1]
    dev = batch_u8.device
    limit = src - img_size + 1
    oh = torch.randint(0, limit, (b,), generator=generator, device=dev)
    ow = torch.randint(0, limit, (b,), generator=generator, device=dev)
    flip = torch.rand(b, generator=generator, device=dev) > 0.5
    return crop_flip_normalize(batch_u8, oh, ow, flip, img_size=img_size, dtype=dtype)
