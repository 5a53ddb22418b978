"""The models the harness runs, one file each: ``models/<model>.py``, found by
a configuration's ``model`` key (``get``). The harness keeps no model's
name: whatever it asks of a model, it asks of that file.

A model file defines, each taking the configuration (``config``) or the
cell (``cell``, its ``config`` inside) as ``portbench.cells`` loads them:

Program side (the program's modules imported inside the functions):
  ``program_config(cell, seed)``: the configuration as the program's CLI
    would hold it;
  ``make_trainer(cell, seed, device)``: the program's trainer through its
    public constructor (the harness then loads the seeded weights);
  ``program_inputs(cell, seed, device)``: what the program's epochs take
    (``cells.resident_rows`` for rows resident on the device);
  ``trained(config)``: the networks that take Adam. Default: all of them.

Data:
  ``counts(config)``: (train X, train Y, val X, val Y) rows; a domain the
    model has not got counts 0;
  ``row_shapes(config)``: the uint8 shape of one row under each key of
    ``counts``' order ("train_x", "train_y", "val_x", "val_y") that has rows;
  ``epoch_pairs(config, n)``: the training pairs of one epoch, ``n`` being
    ``counts``' tuple;
  ``reference_rows(cell, seed, device)``: ``rows(s)``, step s's rows as the
    reference's ``losses`` takes them.

Reference (plain PyTorch, imports nothing of the program; it may live in
``portbench/reference/<model>.py``):
  ``build(config)``: the reference's networks by name, parameters
    uninitialised;
  ``losses(config, nets, rows, seed, step, q)``: (objectives, one per
    gradient group; the logged losses as one tensor) of one step of epoch 0
    on ``rows``, with that step's draws; ``q`` is the control's rounding of
    conv operands (``reference.nets``);
  ``groups``: the gradient groups, a tuple of tuples of network names, one
    ``autograd.grad`` each, in the order of ``losses``' objectives;
  ``normal_params(name)``: whether the parameter ``name`` takes the seeded
    N(0, 0.02) draw (an instance-norm scale then adds 1). Default:
    ``normal_params`` below.

Counts (the yardstick's work of a step, ``portbench.counts``):
  ``step_flops(config, training, bx, by)``, ``epoch_steps(config, n_x,
  n_y)``, ``norm_ops(config, training, bx, by, backward)`` and
  ``stem_ops(config, training, bx, by)``; ``norm_ops`` and ``stem_ops``
  return [] for a kernel that the model does not run.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import re
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
REQUIRED = ("program_config", "make_trainer", "program_inputs", "counts", "row_shapes",
            "epoch_pairs", "reference_rows", "build", "losses", "groups", "step_flops",
            "epoch_steps", "norm_ops", "stem_ops")


def normal_params(name: str) -> bool:
    """Conv kernels and instance-norm scales take the N(0, 0.02) draw."""
    return name.endswith(("conv", "conv512", "scale"))


def get(name: str) -> types.SimpleNamespace:
    """The model ``name``: ``models/<name>.py``'s definitions, with the
    defaults filled in."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid model name: {name!r}")
    return _load(os.path.join(ROOT, name + ".py"), name)


@functools.cache
def _load(path: str, name: str) -> types.SimpleNamespace:
    if not os.path.isfile(path):
        known = sorted(f[:-3] for f in os.listdir(os.path.dirname(path))
                       if f.endswith(".py") and not f.startswith("_"))
        raise ValueError(f"unknown model {name!r}: no {path} (models: {', '.join(known)})")
    spec = importlib.util.spec_from_file_location("portbench_model_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [k for k in REQUIRED if not hasattr(module, k)]
    if missing:
        raise ValueError(f"model {name!r} ({path}) lacks {', '.join(missing)}")
    model = types.SimpleNamespace(name=name, normal_params=normal_params,
                                  trained=lambda config: list(_networks(model, config)))
    for k, v in vars(module).items():
        if not k.startswith("_"):
            setattr(model, k, v)
    return model


def _networks(model, config: dict) -> list:
    import torch
    with torch.device("meta"):
        return list(model.build(config))
