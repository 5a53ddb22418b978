"""Convert gan_tpu network parameters to the port's state_dict and back.

Any network of either model: the U-Net generators and the PatchGAN
discriminators, with instance or batch norm. gan_tpu keeps parameters as a
nested dict (``{"down_1": {"conv": ..., "norm": {"scale": ..., "offset":
...}}, "conv512": ...}``); the
port's state_dict key is that path joined by dots. Every 4-D kernel changes
layout with ``permute(3, 2, 0, 1)``: a conv's HWIO ``(k, k, C_in, C_out)``
becomes OIHW (the PatchGAN's ``conv512`` and ``last.conv`` too), and a TF
transposed conv's ``(k, k, C_out, C_in)`` becomes torch's
``(C_in, C_out, k, k)``. Norm scale/offset (instance) and gamma/beta (batch)
and the last biases are copied as they are. ``networks_to_state_dicts``
converts a trainer's whole ``{network: params}`` tree, such as Pix2Pix's
``{"gen": ..., "disc": ...}``.

Optimizer state: gan_tpu keeps, per network, optax ``adam``'s
``(ScaleByAdamState(count, mu, nu), EmptyState())``. ``mu`` and ``nu`` are
trees like the parameters and become torch Adam's ``exp_avg`` and
``exp_avg_sq`` through the same key path and permute; ``count`` becomes
``step``. Both increment the count before the bias correction, so ``step =
count`` is exact. torch numbers a network's Adam state by the order of
``net.named_parameters()``. ``trainer_state`` converts gan_tpu's whole
trainer state ``{"params", "opt_states"}`` into the port trainer's.
"""

from __future__ import annotations

import numpy as np
import torch

_TO_TORCH = (3, 2, 0, 1)
_TO_TPU = (2, 3, 1, 0)   # inverse of _TO_TORCH


def params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """gan_tpu params (nested dict of arrays) -> port state_dict."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
                continue
            a = np.asarray(v, np.float32)
            if a.ndim == 4:
                a = a.transpose(_TO_TORCH)
            out[prefix + k] = torch.from_numpy(np.array(a, order="C"))   # a writable copy

    walk(params, "")
    return out


def networks_to_state_dicts(params) -> dict[str, dict[str, torch.Tensor]]:
    """gan_tpu trainer params ``{network: params}`` -> ``{network:
    state_dict}``, the ``"params"`` of a port trainer's state."""
    return {name: params_to_state_dict(tree) for name, tree in params.items()}


def adam_state(opt_state, net: torch.nn.Module) -> dict[int, dict[str, torch.Tensor]]:
    """One network's optax adam state -> torch Adam's per-parameter state
    (the ``"state"`` of its ``state_dict``)."""
    adam = opt_state[0]   # ScaleByAdamState; [1] is the EmptyState of the chain
    mu, nu = params_to_state_dict(adam.mu), params_to_state_dict(adam.nu)
    step = float(np.asarray(adam.count))
    return {i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for i, (name, _) in enumerate(net.named_parameters())}


def trainer_state(state, nets: dict, param_groups: dict) -> dict:
    """gan_tpu's trainer state ``{"params", "opt_states"}`` -> the port
    trainer's, for ``load_state``. ``nets``: ``{network: module}``;
    ``param_groups``: ``{network: the port Adam's param_groups}``."""
    return {"params": networks_to_state_dicts(state["params"]),
            "opt_states": {name: {"state": adam_state(state["opt_states"][name], net),
                                  "param_groups": param_groups[name]}
                           for name, net in nets.items()}}


def state_dict_to_params(state_dict) -> dict:
    """Port state_dict -> gan_tpu params (nested dict of numpy arrays)."""
    params: dict = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().float().numpy()
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(_TO_TPU))
        *path, leaf = key.split(".")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return params
