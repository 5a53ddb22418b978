"""CycleGAN's reference in plain PyTorch, float32: two U-Net generators (G:
X to Y, F: Y to X) and two unconditional PatchGANs (``nets``), the step's
draws and passes, and its losses: each generator's BCE against 1, the cycle
L1 of both domains and the identity L1 at half weight, times lambda; each
discriminator's BCE on real and fake images, halved.

The draws: one dropout generator per U-Net pass, and the X and Y jitter at
indices 6 and 7. The passes concatenate the images that one generator takes
(three passes) where the wider domain has at most 4 256²-image equivalents,
and are the six applications otherwise, so the keep-masks of one pass are
split over the applications it holds. The epoch's order is numpy's
permutation of each domain, X then Y, from ``default_rng(SeedSequence([seed
mod 2**32, epoch, 0]))``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.nets import PatchGAN, UNet, generator_depth
from portbench.reference.steps import Step, bce, crop_flip, device_of, jitter_draws, keep_masks, l1

JITTER = (6, 7)
BATCHED_EQUIVALENTS = 4   # 256²-images per domain up to which the passes are batched
# the passes: (generator, the images it takes, the images it makes)
BATCHED = (("gen_g", ("x", "y"), ("fake_y", "same_y")),
           ("gen_f", ("fake_y", "y", "x"), ("cycled_x", "fake_x", "same_x")),
           ("gen_g", ("fake_x",), ("cycled_y",)))
UNBATCHED = (("gen_g", ("x",), ("fake_y",)), ("gen_f", ("fake_y",), ("cycled_x",)),
             ("gen_f", ("y",), ("fake_x",)), ("gen_g", ("fake_x",), ("cycled_y",)),
             ("gen_f", ("x",), ("same_x",)), ("gen_g", ("y",), ("same_y",)))
_DOMAIN = {"x": "x", "fake_y": "x", "y": "y", "fake_x": "y"}
GROUPS = (("gen_g", "gen_f"), ("disc_x", "disc_y"))


def build(config: dict) -> dict:
    """{"gen_g", "gen_f", "disc_x", "disc_y"}, parameters uninitialised."""
    g, d, c = config["generator"], config["discriminator"], config["channels"]
    depth = generator_depth(config["img_size"], g["depth"])

    def unet():
        return UNet(c, g["norm"], depth, g["down_filters"], g["up_blocks"])

    def patchgan():
        return PatchGAN(c, d["norm"], d["conditional"])

    return {"gen_g": unet(), "gen_f": unet(), "disc_x": patchgan(), "disc_y": patchgan()}


def passes(config: dict, bx: int, by: int):
    limit = int(BATCHED_EQUIVALENTS * (256 / config["img_size"]) ** 2)
    return BATCHED if max(bx, by) <= limit else UNBATCHED


def order(seed: int, epoch: int, nx: int, ny: int):
    rng = np.random.default_rng(np.random.SeedSequence([seed % (2**32), epoch, 0]))
    return rng.permutation(nx), rng.permutation(ny)


def draws(step: Step, u8x: torch.Tensor, u8y: torch.Tensor):
    """(x, y, masks by the image each application makes) of a step."""
    size, rows = step.config["img_size"], {"x": u8x.shape[0], "y": u8y.shape[0]}
    masks = {}
    for k, (net, inputs, outputs) in enumerate(passes(step.config, *rows.values())):
        widths = [rows[_DOMAIN[i]] for i in inputs]
        drawn = keep_masks(step.nets[net].dropout_shapes(sum(widths), size), step.gen(k),
                           step.device)
        lo = 0
        for name, w in zip(outputs, widths):
            masks[name] = [m[lo:lo + w] for m in drawn]
            lo += w
    x = crop_flip(u8x, *jitter_draws(rows["x"], u8x.shape[1], size, step.gen(JITTER[0]),
                                     step.device), size)
    y = crop_flip(u8y, *jitter_draws(rows["y"], u8y.shape[1], size, step.gen(JITTER[1]),
                                     step.device), size)
    return x, y, masks


def objectives(config, nets, x, y, masks, q):
    """((both generators', both discriminators' objective), [adv_g, adv_f,
    cycle, G's total, F's total, disc_x, disc_y])."""
    g, f, lam = nets["gen_g"], nets["gen_f"], float(config["lambda"])
    fake_y = g(x, masks["fake_y"], q)
    cycled_x = f(fake_y, masks["cycled_x"], q)
    fake_x = f(y, masks["fake_x"], q)
    cycled_y = g(fake_x, masks["cycled_y"], q)
    same_x, same_y = f(x, masks["same_x"], q), g(y, masks["same_y"], q)
    dx_real, dx_fake = nets["disc_x"](x, q=q), nets["disc_x"](fake_x, q=q)
    dy_real, dy_fake = nets["disc_y"](y, q=q), nets["disc_y"](fake_y, q=q)
    adv_g, adv_f = bce(1.0, dy_fake), bce(1.0, dx_fake)
    cycle = lam * l1(x, cycled_x) + lam * l1(y, cycled_y)
    id_g, id_f = lam * 0.5 * l1(y, same_y), lam * 0.5 * l1(x, same_x)
    disc_x = (bce(1.0, dx_real) + bce(0.0, dx_fake)) * 0.5
    disc_y = (bce(1.0, dy_real) + bce(0.0, dy_fake)) * 0.5
    losses = torch.stack([adv_g, adv_f, cycle, adv_g + cycle + id_g, adv_f + cycle + id_f,
                          disc_x, disc_y])
    return (adv_g + adv_f + cycle + id_g + id_f, disc_x + disc_y), losses


def losses(config, nets, rows, seed: int, step: int, q):
    """``rows``: the step's (X, Y) uint8 rows, each (B, S', S', C)."""
    draw = Step(config, nets, seed, step, device_of(nets))
    return objectives(config, nets, *draws(draw, *rows), q)
