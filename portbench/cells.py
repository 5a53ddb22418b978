"""A cell, found by its name: ``workloads/<cell>.json`` (the traffic: where
the corpus lives, the chips, the limits of the comparison) and the
``configs/<config>.json`` it names (the model and the run as the published
run states them). A key of the workload's ``overrides`` replaces the
configuration's. This module makes what a run hands the program and the
reference alike: the seeded weights, the seeded rows or the file lists, and
the trainer, built through the program's public constructor.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

import numpy as np

from portbench import corpus

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WEIGHTS_KEY, ROWS_KEY = 0, 1   # the seed's streams: weights, resident rows


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"not a valid {kind} name: {name!r}")
    path = os.path.join(ROOT, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load(name: str) -> dict:
    """The cell ``name``: its workload file, with ``config`` the named
    configuration (overrides applied)."""
    cell = _json("workloads", name)
    config = dict(_json("configs", cell["config"]), **cell.get("overrides", {}))
    return dict(cell, config=config)


def benchmark() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def keyed(seed: int, key: int, device):
    import torch
    state = np.random.SeedSequence([seed, key]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def param_specs(config: dict) -> dict:
    """{network: [(parameter name, shape)]}, from the reference's networks."""
    import torch
    from portbench.reference import nets
    with torch.device("meta"):
        built = nets.build(config)
    return {net: [(n, tuple(p.shape)) for n, p in m.named_parameters()] for net, m in built.items()}


def make_weights(config: dict, seed: int, device) -> dict:
    """{network: {parameter: tensor}}, fp32 on ``device``, as the reference
    initialises them: every conv kernel N(0, 0.02), instance-norm scales
    N(1, 0.02), batch-norm gammas 1, offsets, betas and biases 0. The normal
    draws are one call on the device from the seed."""
    import torch
    specs = param_specs(config)
    normal = [(net, n, s) for net, ps in specs.items() for n, s in ps
              if n.endswith(("conv", "conv512", "scale"))]
    flat = torch.randn(sum(int(np.prod(s)) for _, _, s in normal), generator=keyed(
        seed, WEIGHTS_KEY, device), device=device).mul_(0.02)
    out = {net: {} for net in specs}
    lo = 0
    for net, n, s in normal:
        k = int(np.prod(s))
        t = flat[lo:lo + k].view(s)
        out[net][n] = t.add_(1.0) if n.endswith("scale") else t
        lo += k
    for net, ps in specs.items():
        for n, s in ps:
            if n not in out[net]:
                fill = 1.0 if n.endswith("gamma") else 0.0
                out[net][n] = torch.full(s, fill, device=device)
    return out


def counts(cell: dict) -> tuple[int, int, int, int]:
    """(train X, train Y, val X, val Y) rows; Pix2Pix's Y counts are 0."""
    c = cell["config"]
    if c["model"] == "pix2pix":
        return c["train_pairs"], 0, c["val_pairs"], 0
    return c["train_x"], c["train_y"], c["val_x"], c["val_y"]


def row_shapes(cell: dict) -> dict:
    c = cell["config"]
    s, ch, pad = c["img_size"], c["channels"], c["jitter_pad"]
    pair = (2,) if c["model"] == "pix2pix" else ()
    return {"train": (*pair, s + pad, s + pad, ch), "val": (*pair, s, s, ch)}


def resident_rows(cell: dict, seed: int, device) -> dict:
    """The corpus as uint8 rows on the device, from the seed: {"train_x",
    "train_y", "val_x", "val_y"} (Pix2Pix: the pairs under the "_x" keys),
    each made by one call."""
    import torch
    g = keyed(seed, ROWS_KEY, device)
    shapes = row_shapes(cell)
    out = {}
    for key, n in zip(("train_x", "train_y", "val_x", "val_y"), counts(cell)):
        if n:
            out[key] = torch.randint(0, 256, (n, *shapes[key[:-2]]), generator=g, device=device,
                                     dtype=torch.uint8)
    return out


def file_lists(cell: dict, seed: int) -> tuple[list, list]:
    """(train, val) pair files of a file cell, drawn from its pool by the seed."""
    n_train, _, n_val, _ = counts(cell)
    pool = corpus.pair_pool(dict(cell["corpus"], files=n_train + n_val))
    return corpus.split(pool, n_train, n_val, seed)


def program_inputs(cell: dict, seed: int, device) -> dict:
    """What the program's epochs take: resident rows on the device, or
    FileCaches (the program's own streamed path, ``--host-cache off``)."""
    if cell["storage"] == "resident":
        return resident_rows(cell, seed, device)
    if cell["storage"] != "files" or cell["config"]["model"] != "pix2pix":
        raise ValueError(f"unknown storage {cell['storage']!r} for {cell['config']['model']}")
    from gan_tpu_torch.data import loader, pipeline
    c = cell["config"]
    train, val = file_lists(cell, seed)
    rows = {t: pipeline.pix2pix_rows(img_size=c["img_size"], channels=c["channels"],
                                     orient="left", train=t) for t in (True, False)}
    return {"train_x": loader.host_or_file_cache(train, rows[True], c["batch_size"], "off"),
            "val_x": loader.host_or_file_cache(val, rows[False], c["batch_size"], "off")}


def program_config(cell: dict, seed: int):
    """The configuration as the program's CLI would hold it."""
    from gan_tpu_torch.config import CycleGANConfig, Pix2PixConfig
    c = cell["config"]
    common = dict(output="", img_size=c["img_size"], batch_size=c["batch_size"],
                  channels=str(c["channels"]), seed=seed, train=True, dtype=c["dtype"],
                  learning_rate=c["learning_rate"], beta_1=c["beta_1"], beta_2=c["beta_2"],
                  validation_size=c["validation_size"], remat=c["remat"],
                  host_cache="off" if cell["storage"] == "files" else "auto", lam=c["lambda"])
    if c["model"] == "pix2pix":
        cfg = Pix2PixConfig(generator_loss=c["generator_loss"], input_img_orient="left", **common)
    else:
        cfg = CycleGANConfig(**common)
    cfg.validate()
    return cfg


def make_trainer(cell: dict, seed: int, device, marks: Optional[list] = None):
    """The program's trainer through its public constructor, on ``device``,
    with the seeded weights loaded; ``marks`` gets the time of each part."""
    from gan_tpu_torch.parallel import single
    from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
    from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
    cfg = program_config(cell, seed)
    cls = Pix2PixTrainer if cell["config"]["model"] == "pix2pix" else CycleGANTrainer
    trainer = cls(cfg, single(device))
    if marks is not None:
        marks.append(("trainer built", time.perf_counter()))
    trainer.load_state({"params": make_weights(cell["config"], seed, device)})
    return trainer


def run_epoch(trainer, inputs: dict, epoch: int, training: bool):
    """The epoch body of the program's ``fit``: one pass over the train or
    the val split; (steps, K) losses."""
    split = "train" if training else "val"
    caches = [inputs[f"{split}_{d}"] for d in "xy" if f"{split}_{d}" in inputs]
    return trainer.run_epoch(*caches, epoch, training=training)
