"""Epoch shuffles and batch counts (the pure-numpy part of
gan_tpu/train/loop.py: ``epoch_rng``, ``epoch_perm``, ``epoch_plan``).

The port keeps its own copy because gan_tpu's module imports jax.
"""

from __future__ import annotations

import numpy as np


def epoch_rng(seed: int, epoch: int, stream: int = 0) -> np.random.Generator:
    """Host RNG for one epoch's shuffle draws, a pure function of (seed,
    epoch, stream), so a re-run of an epoch draws the same orders. ``stream``
    separates the train (0) and val (1) draws."""
    return np.random.default_rng(np.random.SeedSequence([seed % (2**32), epoch, stream]))


def epoch_perm(n: int, buffer_size: int, rng: np.random.Generator) -> np.ndarray:
    """Epoch order honoring ``--buffer-size``: tf.data's windowed shuffle (a
    buffer of ``buffer_size`` elements, each output drawn uniformly from it
    and replaced by the next stream element). At buffer_size >= n it is a
    full uniform permutation."""
    if buffer_size >= n:
        return rng.permutation(n)
    b = min(buffer_size, n)
    buf = np.arange(b)
    out = np.empty(n, np.int64)
    # the draw bounds are known ahead (b while the stream refills the buffer,
    # then b-1, ..., 1 as it drains), so all draws are made in one call; the
    # buffer chase is sequential
    ends = np.concatenate([np.full(n - b, b, np.int64), np.arange(b, 0, -1)])
    js = rng.integers(0, ends)
    nxt = b
    for i in range(n - b):
        j = js[i]
        out[i] = buf[j]
        buf[j] = nxt
        nxt += 1
    for i in range(n - b, n):
        j = js[i]
        out[i] = buf[j]
        buf[j] = buf[ends[i] - 1]
    return out


def epoch_plan(n: int, batch_size: int) -> tuple[int, int]:
    """(full batches, size of the partial last batch) of ``n`` rows; tf.data
    batches without dropping the remainder."""
    return n // batch_size, n % batch_size
