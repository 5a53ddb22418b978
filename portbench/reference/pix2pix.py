"""Pix2Pix's reference in plain PyTorch, float32: the U-Net generator and the
conditional PatchGAN (``nets``), the step's draws (dropout at index 0,
jitter at index 1, one crop and flip for both images of a pair) and its
losses: the generator's BCE against 1 plus lambda times L1, the
discriminator's BCE on real and fake pairs, halved."""

from __future__ import annotations

import torch

from portbench.reference.nets import PatchGAN, UNet, generator_depth
from portbench.reference.steps import Step, bce, crop_flip, device_of, jitter_draws, keep_masks, l1

DROPOUT, JITTER = 0, 1
GROUPS = (("gen",), ("disc",))


def build(config: dict) -> dict:
    """{"gen", "disc"}, parameters uninitialised."""
    g, d, c = config["generator"], config["discriminator"], config["channels"]
    return {"gen": UNet(c, g["norm"], generator_depth(config["img_size"], g["depth"]),
                        g["down_filters"], g["up_blocks"]),
            "disc": PatchGAN(c, d["norm"], d["conditional"])}


def draws(step: Step, u8: torch.Tensor):
    """(x, y, masks) of a step on (B, 2, S', S', C) uint8 rows."""
    b, size = u8.shape[0], step.config["img_size"]
    masks = keep_masks(step.nets["gen"].dropout_shapes(b, size), step.gen(DROPOUT), step.device)
    oh, ow, flip = jitter_draws(b, u8.shape[2], size, step.gen(JITTER), step.device)
    return crop_flip(u8[:, 0], oh, ow, flip, size), crop_flip(u8[:, 1], oh, ow, flip, size), \
        {"fake": masks}


def objectives(config, nets, x, y, masks, q):
    """((generator's, discriminator's objective), [total, gan, l1, disc])."""
    if config["generator_loss"] != "l1":
        raise ValueError(f"the reference has no {config['generator_loss']!r} generator loss")
    fake = nets["gen"](x, masks["fake"], q)
    d_real, d_fake = nets["disc"](x, y, q), nets["disc"](x, fake, q)
    gan, sec = bce(1.0, d_fake), l1(y, fake)
    total = gan + float(config["lambda"]) * sec
    disc = (bce(1.0, d_real) + bce(0.0, d_fake)) * 0.5
    return (total, disc), torch.stack([total, gan, sec, disc])


def losses(config, nets, rows, seed: int, step: int, q):
    draw = Step(config, nets, seed, step, device_of(nets))
    return objectives(config, nets, *draws(draw, rows), q)
