"""Convert gan_tpu network parameters to the port's state_dict and back.

Any of CycleGAN's four networks: the U-Net generators and the PatchGAN
discriminators. gan_tpu keeps parameters as a nested dict (``{"down_1":
{"conv": ..., "norm": {"scale": ..., "offset": ...}}, "conv512": ...}``); the
port's state_dict key is that path joined by dots. Every 4-D kernel changes
layout with ``permute(3, 2, 0, 1)``: a conv's HWIO ``(k, k, C_in, C_out)``
becomes OIHW (the PatchGAN's ``conv512`` and ``last.conv`` too), and a TF
transposed conv's ``(k, k, C_out, C_in)`` becomes torch's
``(C_in, C_out, k, k)``. Norm scale/offset and the last biases are copied as
they are.
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
