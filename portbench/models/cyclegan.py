"""CycleGAN (kingjosephm/GAN's unpaired model), as the harness runs it: the
program's ``CycleGANTrainer`` on rows of the X and Y domains resident on the
device ((B, S', S', C) uint8 each; an epoch is the zip of the two domains'
permutations); the reference in ``portbench/reference/cyclegan.py``; the
counts of its step."""

from __future__ import annotations

from portbench import cells
from portbench.counts import macs, norm_sites, patchgan_convs, site_norm_ops, stem_op, unet_convs
from portbench.reference import cyclegan as reference
from portbench.reference.cyclegan import GROUPS as groups, build, losses  # noqa: F401

# the networks that the program's trainer builds, as a configuration states them
PROGRAM = {"generator": {"norm": "instance", "depth": 8,
                         "down_filters": [64, 128, 256, 512, 512, 512, 512, 512],
                         "up_blocks": [[512, True], [512, True], [512, True], [512, False],
                                       [256, False], [128, False], [64, False]]},
           "discriminator": {"norm": "instance", "conditional": False}}


# program side

def program_config(cell: dict, seed: int):
    from gan_tpu_torch.config import CycleGANConfig
    cells.check_networks(cell["config"], PROGRAM)
    cfg = CycleGANConfig(**cells.program_args(cell, seed))
    cfg.validate()
    return cfg


def make_trainer(cell: dict, seed: int, device):
    from gan_tpu_torch.parallel import single
    from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
    return CycleGANTrainer(program_config(cell, seed), single(device))


def program_inputs(cell: dict, seed: int, device) -> dict:
    if cell["storage"] != "resident":
        raise ValueError(f"storage {cell['storage']!r}: this model runs resident rows only")
    return cells.resident_rows(cell, seed, device)


# data

def counts(config: dict) -> tuple[int, int, int, int]:
    return config["train_x"], config["train_y"], config["val_x"], config["val_y"]


def row_shapes(config: dict) -> dict:
    s, ch, pad = config["img_size"], config["channels"], config["jitter_pad"]
    train, val = (s + pad, s + pad, ch), (s, s, ch)
    return {"train_x": train, "train_y": train, "val_x": val, "val_y": val}


def epoch_pairs(config: dict, n) -> int:
    """The zip of the two domains: one X and one Y image are one pair."""
    return min(n[0], n[1])


def reference_rows(cell: dict, seed: int, device):
    """Step s's (X, Y) rows, in epoch 0's order of each domain."""
    import torch
    if cell["storage"] != "resident":
        raise ValueError(f"storage {cell['storage']!r}: this model runs resident rows only")
    b = cell["config"]["batch_size"]
    data = cells.resident_rows(cell, seed, device)
    order = reference.order(seed, 0, *counts(cell["config"])[:2])

    def rows(s):
        return tuple(data[k][torch.from_numpy(o[s * b:(s + 1) * b]).to(device)]
                     for k, o in zip(("train_x", "train_y"), order))
    return rows


# counts

def step_flops(config: dict, training: bool, bx: int, by: int = 0) -> float:
    g, gs = macs(unet_convs(config))
    d, ds = macs(patchgan_convs(config))
    rows = bx + by
    if not training:
        return 2.0 * (3 * rows * g + 2 * rows * d)
    # six generator applications of 3·rows rows in all, of which F(fake_y)
    # and G(fake_x) take their stem's dgrad; D on real (rows) and on fake
    # (rows) images
    return 2.0 * (3 * rows * (3 * g - gs) + rows * gs + rows * (3 * d - ds)
                  + rows * (4 * d - ds))


def epoch_steps(config: dict, n_x: int, n_y: int = 0) -> list[tuple[int, int, int]]:
    """The zip of the two domains: full batches of both, then a tail that
    takes what each domain has left, up to a batch."""
    b = config["batch_size"]
    full, tail = divmod(min(n_x, n_y), b)
    steps = [(full, b, b)] if full else []
    if tail:
        steps.append((1, min(b, n_x - full * b), min(b, n_y - full * b)))
    return steps


def norm_ops(config: dict, training: bool, bx: int, by: int, backward: bool) -> list:
    """Every instance norm of the step (none for a batch-norm generator)."""
    if config["generator"]["norm"] != "instance":
        return []
    gen, disc = norm_sites(config)
    rows, dt = bx + by, config["dtype"]
    if not backward:
        return site_norm_ops(gen, 3 * rows, dt, False) + site_norm_ops(disc, 2 * rows, dt, False)
    if not training:
        return []
    # the generators' walk: every generator application and D on the fakes;
    # the discriminators' walk: D on real and on fake images
    return site_norm_ops(gen, 3 * rows, dt, True) + site_norm_ops(disc, rows + 2 * rows, dt, True)


def stem_ops(config: dict, training: bool, bx: int, by: int = 0) -> list[tuple[float, float]]:
    """Each generator application's stem, then each discriminator's."""
    c = config["channels"]
    return ([stem_op(config, r, c) for r in (bx, bx, by, by, bx, by)]
            + [stem_op(config, r, c) for r in (bx, by, by, bx)])
