"""CycleGAN's composite losses (counterpart of gan_tpu/losses.py).

* ``discriminator_loss``: (BCE(1, real) + BCE(0, generated)) · factor, called
  with factor 0.5;
* ``generator_adversarial_loss``: BCE(1, D(fake));
* ``cycle_loss``: λ · mean|real − cycled|;
* ``identity_loss``: λ · 0.5 · mean|real − same|.

``CYCLEGAN_LOSS_KEYS`` name the metrics JSON entries and the figure files,
byte for byte as in the reference. gan_tpu's ``sg_tree`` has no counterpart:
the port takes each network's gradient with its own ``torch.autograd.grad``
(train/cyclegan_trainer.py). The Pix2Pix losses come with the Pix2Pix path.
"""

from __future__ import annotations

import torch

from gan_tpu_torch.ops.loss_ops import bce_with_logits, l1_loss

CYCLEGAN_LOSS_KEYS = (
    "X->Y Generator Loss",
    "Y->X Generator Loss",
    "Total Cycle Loss",
    "Total X->Y Generator Loss",
    "Total Y->X Generator Loss",
    "Discriminator X Loss",
    "Discriminator Y Loss",
)


def empty_losses(keys) -> dict:
    """Empty per-epoch loss lists, one per key."""
    return {k: [] for k in keys}


def discriminator_loss(disc_real_logits, disc_generated_logits, factor: float = 0.5):
    real = bce_with_logits(torch.ones_like(disc_real_logits), disc_real_logits)
    gen = bce_with_logits(torch.zeros_like(disc_generated_logits), disc_generated_logits)
    return (real + gen) * factor


def generator_adversarial_loss(disc_generated_logits):
    return bce_with_logits(torch.ones_like(disc_generated_logits), disc_generated_logits)


def cycle_loss(real, cycled, lam: float):
    return lam * l1_loss(real, cycled)


def identity_loss(real, same, lam: float):
    return lam * 0.5 * l1_loss(real, same)
