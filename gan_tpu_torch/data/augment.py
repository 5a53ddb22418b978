"""Deterministic normalization of the val/test/predict path
(counterpart of gan_tpu/data/augment.py ``normalize_batch``)."""

from __future__ import annotations

import torch


def normalize_batch(batch_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8-valued -> [-1, 1] in ``dtype``, on the tensor's device: x/127.5 - 1."""
    return batch_u8.to(dtype) / 127.5 - 1.0
