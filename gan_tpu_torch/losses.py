"""Pix2Pix's and CycleGAN's composite losses (counterpart of gan_tpu/losses.py).

* ``discriminator_loss``: (BCE(1, real) + BCE(0, generated)) · factor, called
  with factor 0.5;
* ``generator_adversarial_loss``: BCE(1, D(fake));
* ``pix2pix_secondary_loss``: L1 mean|target − G(x)|, or gan_tpu's corrected
  SSIM loss 1 − SSIM(G(x), target) (``--generator-loss ssim``);
* ``pix2pix_generator_loss``: (adversarial + λ · secondary, adversarial,
  secondary);
* ``cycle_loss``: λ · mean|real − cycled|;
* ``identity_loss``: λ · 0.5 · mean|real − same|;
* pix2pixHD's (NVIDIA/pix2pixHD models/pix2pixHD_model.py and networks.py):
  ``lsgan_loss``, the MSE of each scale's patch scores against 1 or 0,
  summed over the scales; ``feature_matching_loss``, λ_feat · 4 / (n_layers
  + 1) / num_D · Σ L1(D(fake)'s feature, D(real)'s, detached) over the
  scales and the intermediate features; ``vgg_loss``, λ_feat · Σ wᵢ ·
  L1(VGG(fake)ᵢ, VGG(real)ᵢ detached).

``PIX2PIX_LOSS_KEYS`` and ``CYCLEGAN_LOSS_KEYS`` name the metrics JSON
entries and the figure files, byte for byte as in the reference. gan_tpu's
``sg_tree`` has no counterpart: the port takes each network's gradient with
its own ``torch.autograd.grad`` (train/cyclegan_trainer.py,
train/pix2pix_trainer.py).
"""

from __future__ import annotations

import torch

from gan_tpu_torch.ops.loss_ops import bce_with_logits, l1_loss
from gan_tpu_torch.ops.ssim import ssim_loss

PIX2PIX_LOSS_KEYS = (
    "Generator Total Loss",
    "Generator Loss (Primary)",
    "Generator Loss (Secondary)",
    "Discriminator Loss",
)
CYCLEGAN_LOSS_KEYS = (
    "X->Y Generator Loss",
    "Y->X Generator Loss",
    "Total Cycle Loss",
    "Total X->Y Generator Loss",
    "Total Y->X Generator Loss",
    "Discriminator X Loss",
    "Discriminator Y Loss",
)
PIX2PIXHD_LOSS_KEYS = ("G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake")   # pix2pixHD's names


def empty_losses(keys) -> dict:
    """Empty per-epoch loss lists, one per key."""
    return {k: [] for k in keys}


def discriminator_loss(disc_real_logits, disc_generated_logits, factor: float = 0.5):
    real = bce_with_logits(torch.ones_like(disc_real_logits), disc_real_logits)
    gen = bce_with_logits(torch.zeros_like(disc_generated_logits), disc_generated_logits)
    return (real + gen) * factor


def generator_adversarial_loss(disc_generated_logits):
    return bce_with_logits(torch.ones_like(disc_generated_logits), disc_generated_logits)


def pix2pix_secondary_loss(gen_output, target, kind: str):
    """The λ-weighted secondary generator loss: 'l1' or 'ssim'."""
    if kind == "l1":
        return l1_loss(target, gen_output)
    if kind == "ssim":
        return ssim_loss(gen_output, target)
    raise ValueError(f"unknown generator loss {kind!r}")


def pix2pix_generator_loss(disc_generated_logits, gen_output, target, *, lam: float,
                           kind: str = "l1"):
    """(total, adversarial, secondary)."""
    gan = generator_adversarial_loss(disc_generated_logits)
    secondary = pix2pix_secondary_loss(gen_output, target, kind)
    return gan + lam * secondary, gan, secondary


def cycle_loss(real, cycled, lam: float):
    return lam * l1_loss(real, cycled)


def identity_loss(real, same, lam: float):
    return lam * 0.5 * l1_loss(real, same)


def lsgan_loss(scales, real: bool):
    """Σ over the scales of mean((patch scores − target)²), the target 1 or 0;
    ``scales``: each scale's outputs, the patch scores last."""
    target = 1.0 if real else 0.0
    return sum((outs[-1].float() - target).square().mean() for outs in scales)


def feature_matching_loss(fake_scales, real_scales, *, n_layers: int, lam: float):
    """pix2pixHD's discriminator feature matching: the L1 between D(fake)'s
    and D(real)'s intermediate features, D(real)'s detached, weighted
    4 / (n_layers + 1) · 1 / num_D · λ_feat."""
    weight = 4.0 / (n_layers + 1) / len(fake_scales) * lam
    return sum(weight * (f.float() - r.detach().float()).abs().mean()
               for fake, real in zip(fake_scales, real_scales)
               for f, r in zip(fake[:-1], real[:-1]))


def vgg_loss(fake_taps, real_taps, weights, *, lam: float):
    """pix2pixHD's VGGLoss times λ_feat: Σ wᵢ · L1(fake tap i, real tap i
    detached)."""
    return lam * sum(w * (f.float() - r.detach().float()).abs().mean()
                     for w, f, r in zip(weights, fake_taps, real_taps))
