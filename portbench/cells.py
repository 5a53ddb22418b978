"""A cell, found by its name: ``workloads/<cell>.json`` (the traffic: where
the corpus lives, the chips, the limits of the comparison) and the
``configs/<config>.json`` it names (the model and the run as the published
run states them). A key of the workload's ``overrides`` replaces the
configuration's. This module makes what a run hands the program and the
reference alike: the seeded weights, the seeded rows or the file lists, and
the trainer, built through the program's public constructor. Whatever
depends on the model, it asks of the configuration's model file
(``portbench.models``).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Optional

import numpy as np

from portbench import corpus, models

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


def model(config: dict):
    """The configuration's model: ``models/<model>.py``, by its ``model`` key."""
    return models.get(config["model"])


def param_specs(config: dict) -> dict:
    """{network: [(parameter name, shape)]}, from the reference's networks."""
    import torch
    with torch.device("meta"):
        built = model(config).build(config)
    return {net: [(n, tuple(p.shape)) for n, p in m.named_parameters()] for net, m in built.items()}


def make_weights(config: dict, seed: int, device) -> dict:
    """{network: {parameter: tensor}}, fp32 on ``device``, as the reference
    initialises them: the parameters that the model's ``normal_params``
    names (by default every conv kernel, and instance-norm scales, which
    then add 1) N(0, 0.02); batch-norm gammas 1; offsets, betas and biases 0.
    The normal draws are one call on the device from the seed."""
    import torch
    specs = param_specs(config)
    normal_params = model(config).normal_params
    normal = [(net, n, s) for net, ps in specs.items() for n, s in ps if normal_params(n)]
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
    """(train X, train Y, val X, val Y) rows; a domain the model has not got
    counts 0."""
    return tuple(model(cell["config"]).counts(cell["config"]))


def row_shapes(cell: dict) -> dict:
    """{"train_x", ...: the uint8 shape of one row}, for the keys with rows."""
    return model(cell["config"]).row_shapes(cell["config"])


def resident_rows(cell: dict, seed: int, device) -> dict:
    """The corpus as uint8 rows on the device, from the seed: {"train_x",
    "train_y", "val_x", "val_y"} for the keys with rows, each made by one
    call, in that order."""
    import torch
    g = keyed(seed, ROWS_KEY, device)
    shapes = row_shapes(cell)
    out = {}
    for key, n in zip(("train_x", "train_y", "val_x", "val_y"), counts(cell)):
        if n:
            out[key] = torch.randint(0, 256, (n, *shapes[key]), generator=g, device=device,
                                     dtype=torch.uint8)
    return out


def file_lists(cell: dict, seed: int) -> tuple[list, list]:
    """(train, val) pair files of a file cell, drawn from its pool by the
    seed: as many as the X domain's train and val rows."""
    n_train, _, n_val, _ = counts(cell)
    pool = corpus.pair_pool(dict(cell["corpus"], files=n_train + n_val))
    return corpus.split(pool, n_train, n_val, seed)


def program_inputs(cell: dict, seed: int, device) -> dict:
    """What the program's epochs take: resident rows on the device, or what
    the model streams them from."""
    return model(cell["config"]).program_inputs(cell, seed, device)


def check_networks(config: dict, program: dict) -> None:
    """Raises where the configuration states other networks than the
    program's trainer builds (``program``: {key: the program's value})."""
    for key, value in program.items():
        if config[key] != value:
            raise ValueError(f"{config['name']}: {key} {config[key]!r} is not what the "
                             f"program runs ({value!r})")


def program_args(cell: dict, seed: int) -> dict:
    """The program's configuration keys that every model's CLI shares."""
    c = cell["config"]
    return dict(output="", img_size=c["img_size"], batch_size=c["batch_size"],
                channels=str(c["channels"]), seed=seed, train=True, dtype=c["dtype"],
                learning_rate=c["learning_rate"], beta_1=c["beta_1"], beta_2=c["beta_2"],
                validation_size=c["validation_size"], remat=c["remat"],
                host_cache="off" if cell["storage"] == "files" else "auto", lam=c["lambda"])


def program_config(cell: dict, seed: int):
    """The configuration as the program's CLI would hold it."""
    return model(cell["config"]).program_config(cell, seed)


def make_trainer(cell: dict, seed: int, device, marks: Optional[list] = None):
    """The program's trainer through its public constructor, on ``device``,
    with the seeded weights loaded; ``marks`` gets the time of each part."""
    trainer = model(cell["config"]).make_trainer(cell, seed, device)
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
