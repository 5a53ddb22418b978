"""pix2pixHD (NVIDIA's label-to-image model, ``--netG global``), as the
harness runs it: the program's ``Pix2PixHDTrainer`` on rows resident on the
device ((H, W, 6) uint8: label id, instance id's high and low byte, R, G,
B), made here from the seed; the reference in
``portbench/reference/pix2pixhd.py``; the counts of its step. The VGG19
trunk is frozen: it takes no Adam and no change reading. Its seeded
kernels are loaded at He scale on both sides (``he_scaled``), so that its
term and its gradient into the fake weigh in the compared numbers."""

from __future__ import annotations

import math

from portbench import cells
from portbench.counts import DTYPE_BYTES, NORM_BWD_FLOPS, NORM_FWD_FLOPS
from portbench.reference import pix2pixhd as reference
from portbench.reference.pix2pixhd import GROUPS as groups, losses  # noqa: F401

LABEL_CELL, INST_CELL = 32, 64   # pixels of the rows' label and instance regions at 512 rows
# the Adam of the program's trainer: torch's epsilon and pix2pixHD's fixed beta_2
PROGRAM = {"adam_epsilon": 1e-8, "beta_2": 0.999}
DRAW_STD = 0.02   # cells.make_weights' normal draw


def normal_params(name: str) -> bool:
    """Conv weights take the N(0, 0.02) draw; biases start at 0."""
    return name.endswith("weight")


def trained(config: dict) -> list:
    return ["gen"] + [f"disc_{i}" for i in range(config["num_D"])]


def he_scaled(vgg):
    """``vgg`` (the program's trunk or the reference's), whose
    ``load_state_dict`` takes each seeded N(0, 0.02) kernel at He scale,
    N(0, 2 / fan_in), as ImageNet's weights keep the activations' scale:
    at 0.02 the taps shrink layer by layer and the VGG term weighs about
    1/1000 of G's loss."""
    def rescale(_module, state_dict, prefix, *_args):
        for k, w in list(state_dict.items()):
            if k.startswith(prefix) and k.endswith("weight"):
                state_dict[k] = w * (math.sqrt(2.0 / w[0].numel()) / DRAW_STD)

    vgg.register_load_state_dict_pre_hook(rescale)
    return vgg


def build(config: dict) -> dict:
    """The reference's networks (``reference.build``), the VGG ``he_scaled``."""
    nets = reference.build(config)
    he_scaled(nets["vgg"])
    return nets


# program side

def program_config(cell: dict, seed: int):
    from gan_tpu_torch.config import Pix2PixHDConfig
    c = cell["config"]
    cells.check_networks(c, PROGRAM)
    if cell["storage"] != "resident":
        raise ValueError(f"storage {cell['storage']!r}: this model runs resident rows only")
    keys = ("label_nc", "ngf", "n_downsample_global", "n_blocks_global", "num_D", "n_layers_D",
            "ndf", "lambda_feat", "no_instance", "no_flip", "no_vgg_loss", "no_ganFeat_loss",
            "batch_size", "learning_rate", "beta_1", "dtype")
    cfg = Pix2PixHDConfig(output="", train=True, seed=seed, load_size=c["width"],
                          **{k: c[k] for k in keys})
    cfg.validate()
    return cfg


def make_trainer(cell: dict, seed: int, device):
    from gan_tpu_torch.parallel import single
    from gan_tpu_torch.train.pix2pixhd_trainer import Pix2PixHDTrainer
    trainer = Pix2PixHDTrainer(program_config(cell, seed), single(device))
    if trainer.vgg is not None:
        he_scaled(trainer.vgg)
    return trainer


def _rows(config: dict, n: int, generator, device):
    """(n, H, W, 6) uint8 rows: label ids in [0, label_nc) constant over
    square cells of H / 16 pixels (32 at 512 rows), instance ids in [0,
    65536) constant over cells twice as wide (edges on about 6% of pixels
    at 512 rows), uniform RGB bytes."""
    import torch
    h, w = config["height"], config["width"]
    cell = max(2, h * LABEL_CELL // 512)

    def regions(size, high, dtype):
        coarse = torch.randint(0, high, (n, -(-h // size), -(-w // size)), generator=generator,
                               device=device, dtype=dtype)
        return coarse.repeat_interleave(size, 1).repeat_interleave(size, 2)[:, :h, :w]

    label = regions(cell, config["label_nc"], torch.uint8)
    ids = regions(cell * INST_CELL // LABEL_CELL, 1 << 16, torch.int32)
    rgb = torch.randint(0, 256, (n, h, w, 3), generator=generator, device=device,
                        dtype=torch.uint8)
    return torch.cat([label[..., None], (ids >> 8).to(torch.uint8)[..., None],
                      (ids & 0xFF).to(torch.uint8)[..., None], rgb], dim=-1)


def rows(cell: dict, seed: int, device) -> dict:
    """{"train_x", "val_x"}: the split's rows on the device, from the seed."""
    c = cell["config"]
    g = cells.keyed(seed, cells.ROWS_KEY, device)
    return {key: _rows(c, n, g, device)
            for key, n in (("train_x", c["train_pairs"]), ("val_x", c["val_pairs"]))}


def program_inputs(cell: dict, seed: int, device) -> dict:
    if cell["storage"] != "resident":
        raise ValueError(f"storage {cell['storage']!r}: this model runs resident rows only")
    return rows(cell, seed, device)


# data

def counts(config: dict) -> tuple[int, int, int, int]:
    return config["train_pairs"], 0, config["val_pairs"], 0


def row_shapes(config: dict) -> dict:
    shape = (config["height"], config["width"], 6)
    return {"train_x": shape, "val_x": shape}


def epoch_pairs(config: dict, n) -> int:
    return n[0]


def order(seed: int, epoch: int, n: int):
    """A train pass's permutation of the rows (the program's shuffled epoch)."""
    import numpy as np
    return np.random.default_rng(np.random.SeedSequence([seed % (2**32), epoch, 0])).permutation(n)


def reference_rows(cell: dict, seed: int, device):
    """Step s's rows, in epoch 0's permutation."""
    import torch
    b = cell["config"]["batch_size"]
    data = rows(cell, seed, device)["train_x"]
    perm = torch.from_numpy(order(seed, 0, data.shape[0])).to(device)
    return lambda s: data[perm[s * b:(s + 1) * b]]


# counts

def _input_nc(config: dict) -> int:
    return config["label_nc"] + (0 if config["no_instance"] else 1)


def generator_convs(config: dict) -> list[tuple[int, bool]]:
    """(MACs per image, is the stem) of each conv of the generator; a
    transposed conv's per input pixel."""
    h, w, ngf, n = config["height"], config["width"], config["ngf"], config["n_downsample_global"]
    convs = [(h * w * ngf * _input_nc(config) * 49, True)]
    for i in range(n):
        convs.append(((h >> i + 1) * (w >> i + 1) * (ngf << i + 1) * (ngf << i) * 9, False))
    dim = ngf << n
    convs += [((h >> n) * (w >> n) * dim * dim * 9, False)] * (2 * config["n_blocks_global"])
    for i in range(n):
        c = ngf << (n - i)
        convs.append(((h >> n - i) * (w >> n - i) * c * (c // 2) * 9, False))
    convs.append((h * w * 3 * ngf * 49, False))
    return convs


def scale_sizes(config: dict) -> list[tuple[int, int]]:
    """(H, W) that each discriminator sees: the rows pooled 3x3 / 2 (pad 1) i times."""
    sizes = [(config["height"], config["width"])]
    for _ in range(1, config["num_D"]):
        sizes.append(tuple((s - 1) // 2 + 1 for s in sizes[-1]))
    return sizes


def discriminator_layers(config: dict, size) -> list[tuple[int, int, int, int]]:
    """(H_out, W_out, C_in, C_out) of each 4x4, padding-2 conv of one n-layer
    discriminator on an input of ``size``."""
    n, (h, w) = config["n_layers_D"], size
    layers, c = [], _input_nc(config) + 3
    for k in range(n + 2):
        stride = 2 if k < n else 1
        out = 1 if k == n + 1 else min(config["ndf"] << k, 512)
        h, w = h // stride + 1, w // stride + 1
        layers.append((h, w, c, out))
        c = out
    return layers


def discriminator_convs(config: dict, size) -> list[tuple[int, bool]]:
    return [(h * w * c_in * c_out * 16, k == 0)
            for k, (h, w, c_in, c_out) in enumerate(discriminator_layers(config, size))]


def vgg_convs(config: dict) -> list[int]:
    """MACs per image of the VGG19 trunk's 13 convs (none without the VGG loss)."""
    if config["no_vgg_loss"]:
        return []
    from portbench.reference.pix2pixhd import VGG_CONVS, VGG_POOL_BEFORE
    h, w, out = config["height"], config["width"], []
    for i, c_in, c_out in VGG_CONVS:
        if i in VGG_POOL_BEFORE:
            h, w = h // 2, w // 2
        out.append(h * w * c_in * c_out * 9)
    return out


def _macs(convs) -> tuple[int, int]:
    return sum(m for m, _ in convs), sum(m for m, stem in convs if stem)


def step_flops(config: dict, training: bool, bx: int, by: int = 0) -> float:
    g, gs = _macs(generator_convs(config))
    v = sum(vgg_convs(config))
    ds = [_macs(discriminator_convs(config, s)) for s in scale_sizes(config)]
    if not training:   # G, VGG on fake and image, D on the three inputs
        return 2.0 * bx * (g + 2 * v + sum(3 * d for d, _ in ds))
    # G: fwd, wgrad, dgrad but the stem's (the labels need none); VGG: fwd on
    # fake and image, dgrad on fake; each D: fwd on (fake detached, image,
    # fake), in its group wgrad and dgrad but the stem's on the first two,
    # and a dgrad of every layer on the fake for G's group
    return 2.0 * bx * ((3 * g - gs) + 3 * v + sum(8 * d - 2 * s for d, s in ds))


def epoch_steps(config: dict, n_x: int, n_y: int = 0) -> list[tuple[int, int, int]]:
    """Full batches, then the partial last batch; by is 0."""
    b = config["batch_size"]
    full, tail = divmod(n_x, b)
    steps = [(full, b, 0)] if full else []
    if tail:
        steps.append((1, tail, 0))
    return steps


def norm_sites(config: dict) -> tuple[list, list]:
    """(H, W, C) of each instance norm of the generator and of the
    discriminators (every scale's)."""
    h, w, ngf, n = config["height"], config["width"], config["ngf"], config["n_downsample_global"]
    gen = [(h, w, ngf)] + [(h >> i + 1, w >> i + 1, ngf << i + 1) for i in range(n)]
    gen += [(h >> n, w >> n, ngf << n)] * (2 * config["n_blocks_global"])
    gen += [(h >> n - 1 - i, w >> n - 1 - i, ngf << n - 1 - i) for i in range(n)]
    disc = [(hh, ww, c) for s in scale_sizes(config)
            for hh, ww, _c_in, c in discriminator_layers(config, s)[1:-1]]
    return gen, disc


def _site_ops(sites, rows: int, dtype: str, backward: bool) -> list[tuple[float, float]]:
    """(bytes, operations) of an instance norm over ``rows`` images at each
    (H, W, C) site, the counts' rule for square sites (``site_norm_ops``)."""
    e = DTYPE_BYTES[dtype]
    out = []
    for h, w, c in sites:
        n = rows * h * w * c
        out.append((3 * n * e + 3 * c * 4, NORM_BWD_FLOPS * n) if backward
                   else (2 * n * e + 2 * c * 4, NORM_FWD_FLOPS * n))
    return out


def norm_ops(config: dict, training: bool, bx: int, by: int, backward: bool) -> list:
    """Every instance norm of the step: the generator's once; each
    discriminator's on its three inputs, forward, and backward on all three
    in a train step (D's group walks D(fake detached) and D(image), G's
    walks D(fake))."""
    if backward and not training:
        return []
    gen, disc = norm_sites(config)
    dt = config["dtype"]
    return _site_ops(gen, bx, dt, backward) + _site_ops(disc, 3 * bx, dt, backward)


def stem_ops(config: dict, training: bool, bx: int, by: int = 0) -> list:
    """None: no network here has the 4x4 stride-2 one-image stem S fuses."""
    return []
