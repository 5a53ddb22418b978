"""Seeded numpy inputs shared by the port's tests. Imports no jax, so the
card-side kernel tests can use it where jax is absent."""

import numpy as np


def norm_inputs(shape, seed=3):
    """x ~ N(1, 3²) of ``shape`` (N, H, W, C), and per-channel scale ~ N(1, 0.02²)
    and offset ~ N(0, 0.1²), all float32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 1.0).astype(np.float32)
    scale = (1.0 + 0.02 * rng.standard_normal(shape[-1])).astype(np.float32)
    offset = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, scale, offset
