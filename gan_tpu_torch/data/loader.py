"""Batch iteration over a uint8 cache (counterpart of gan_tpu/data/loader.py
``iter_uint8_batches`` for an in-memory cache)."""

from __future__ import annotations

import numpy as np


def iter_uint8_batches(cache: np.ndarray, batch_size: int):
    """Contiguous ``batch_size``-row views of ``cache``, the last one partial."""
    for lo in range(0, cache.shape[0], batch_size):
        yield cache[lo:lo + batch_size]
