"""Elementary loss ops (counterpart of gan_tpu/ops/loss_ops.py), in fp32.

* ``bce_with_logits`` is ``tf.keras.losses.BinaryCrossentropy(from_logits=True)``
  in its stable form, mean over all elements.
* ``l1_loss`` is the mean absolute error of the cycle and identity losses.
"""

from __future__ import annotations

import torch


def bce_with_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """mean(max(z, 0) - z·t + log1p(exp(-|z|)))."""
    z = logits.float()
    t = labels.float()
    return (z.clamp_min(0.0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean |a - b| in fp32."""
    return (a.float() - b.float()).abs().mean()
