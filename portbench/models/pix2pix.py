"""Pix2Pix (kingjosephm/GAN's paired model), as the harness runs it: the
program's ``Pix2PixTrainer`` on rows of image pairs, resident on the device
((B, 2, S', S', C) uint8: input, target) or streamed from pair files
through the program's FileCache; the reference in
``portbench/reference/pix2pix.py``; the counts of its step."""

from __future__ import annotations

from portbench import cells
from portbench.counts import macs, patchgan_convs, stem_op, unet_convs
from portbench.reference import png
from portbench.reference.pix2pix import GROUPS as groups, build, losses  # noqa: F401

# the networks that the program's trainer builds, as a configuration states them
PROGRAM = {"generator": {"norm": "batch", "depth": 8,
                         "down_filters": [64, 128, 256, 512, 512, 512, 512, 512],
                         "up_blocks": [[512, True], [512, True], [512, True], [512, False],
                                       [256, False], [128, False], [64, False]]},
           "discriminator": {"norm": "batch", "conditional": True}}


# program side

def program_config(cell: dict, seed: int):
    from gan_tpu_torch.config import Pix2PixConfig
    c = cell["config"]
    cells.check_networks(c, PROGRAM)
    cfg = Pix2PixConfig(generator_loss=c["generator_loss"], input_img_orient="left",
                        **cells.program_args(cell, seed))
    cfg.validate()
    return cfg


def make_trainer(cell: dict, seed: int, device):
    from gan_tpu_torch.parallel import single
    from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
    return Pix2PixTrainer(program_config(cell, seed), single(device))


def program_inputs(cell: dict, seed: int, device) -> dict:
    """Resident rows, or the program's FileCaches over the cell's pair files
    (its streamed path, ``--host-cache off``)."""
    if cell["storage"] == "resident":
        return cells.resident_rows(cell, seed, device)
    if cell["storage"] != "files":
        raise ValueError(f"unknown storage {cell['storage']!r}")
    from gan_tpu_torch.data import loader, pipeline
    c = cell["config"]
    train, val = cells.file_lists(cell, seed)
    rows = {t: pipeline.pix2pix_rows(img_size=c["img_size"], channels=c["channels"],
                                     orient="left", train=t) for t in (True, False)}
    return {"train_x": loader.host_or_file_cache(train, rows[True], c["batch_size"], "off"),
            "val_x": loader.host_or_file_cache(val, rows[False], c["batch_size"], "off")}


# data

def counts(config: dict) -> tuple[int, int, int, int]:
    """The pairs count as X rows; there is no Y domain."""
    return config["train_pairs"], 0, config["val_pairs"], 0


def row_shapes(config: dict) -> dict:
    s, ch, pad = config["img_size"], config["channels"], config["jitter_pad"]
    return {"train_x": (2, s + pad, s + pad, ch), "val_x": (2, s, s, ch)}


def epoch_pairs(config: dict, n) -> int:
    return n[0]


def reference_rows(cell: dict, seed: int, device):
    """Step s's (B, 2, S', S', C) rows: the resident rows in order (the
    program's epoch 0 takes them so), or the cell's files decoded and resized
    by the reference's own PNG path."""
    import numpy as np
    import torch
    c = cell["config"]
    b = c["batch_size"]
    if cell["storage"] == "files":
        train, _val = cells.file_lists(cell, seed)
        size = c["img_size"] + c["jitter_pad"]

        def rows(s):
            return torch.from_numpy(np.stack([png.pair_row(p, size)
                                              for p in train[s * b:(s + 1) * b]])).to(device)
        return rows
    data = cells.resident_rows(cell, seed, device)

    def rows(s):
        return data["train_x"][s * b:(s + 1) * b]
    return rows


# counts

def step_flops(config: dict, training: bool, bx: int, by: int = 0) -> float:
    g, gs = macs(unet_convs(config))
    d, ds = macs(patchgan_convs(config))
    if not training:
        return 2.0 * bx * (g + 2 * d)
    # G: fwd, wgrad, dgrad but the stem's (x needs none); D(x, y): the
    # same; D(x, fake): fwd, dgrad to G (the stem's too), wgrad and
    # dgrad but the stem's in D's group
    return 2.0 * bx * ((3 * g - gs) + (3 * d - ds) + (4 * d - ds))


def epoch_steps(config: dict, n_x: int, n_y: int = 0) -> list[tuple[int, int, int]]:
    """Full batches of pairs, then the partial last batch; by is 0."""
    b = config["batch_size"]
    full, tail = divmod(n_x, b)
    steps = [(full, b, 0)] if full else []
    if tail:
        steps.append((1, tail, 0))
    return steps


def norm_ops(config: dict, training: bool, bx: int, by: int, backward: bool) -> list:
    """None: the program's Pix2Pix runs batch norm, not K1/K2."""
    return []


def stem_ops(config: dict, training: bool, bx: int, by: int = 0) -> list[tuple[float, float]]:
    """G's stem on x, D's on (x, y) and on (x, fake)."""
    c = config["channels"]
    return [stem_op(config, bx, c), stem_op(config, bx, 2 * c), stem_op(config, bx, 2 * c)]
