"""Seeded numpy inputs and the thread budget shared by the port's tests.
Imports no jax, so the card-side kernel tests can use it where jax is
absent."""

import os

import numpy as np
import torch


def limit_threads() -> None:
    """Under pytest-xdist, torch's intra-op threads of one worker: the
    process's cores shared among the workers (at least 1), where torch
    would give every worker all of them and oversubscribe the cores."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))


def norm_inputs(shape, seed=3):
    """x ~ N(1, 3²) of ``shape`` (N, H, W, C), and per-channel scale ~ N(1, 0.02²)
    and offset ~ N(0, 0.1²), all float32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 1.0).astype(np.float32)
    scale = (1.0 + 0.02 * rng.standard_normal(shape[-1])).astype(np.float32)
    offset = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale, offset
