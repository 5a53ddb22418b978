"""The file cells' corpus: seeded noise PNGs at the size that
``tools/curate_flir.py`` writes the reference's corpus (1280x512 grey pairs,
input left, target right), written once per checkout into a fixed directory
under ``portbench/cache`` and reused by every later run.

Noise does not compress, so decoding a file inflates every byte of it: the
worst case for a PNG decoder. The rows are filtered in turn with None, Sub
and Up, so that the decoder also undoes filters. The pool is written into a
``.partial`` directory and renamed when whole, so that a run cut while
writing leaves nothing that a later run would read; that run writes it again.

The pool does not depend on the run's seed; the seed draws which files form
the train and the val split, and in which order, as the reference's split
shuffles its corpus once.
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = (0, 1, 2)   # None, Sub, Up, row by row
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cache", "corpus")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_grey(pixels: np.ndarray, level: int) -> bytes:
    """An 8-bit greyscale PNG of (H, W) uint8 ``pixels``."""
    h, w = pixels.shape
    x = pixels.astype(np.int16)
    left = np.concatenate([np.zeros((h, 1), np.int16), x[:, :-1]], axis=1)
    up = np.concatenate([np.zeros((1, w), np.int16), x[:-1]], axis=0)
    kinds = np.array(FILTERS, np.uint8)[np.arange(h) % len(FILTERS)]
    body = np.where(kinds[:, None] == 1, x - left, np.where(kinds[:, None] == 2, x - up, x))
    raw = np.concatenate([kinds[:, None], (body & 0xFF).astype(np.uint8)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def pair_pixels(seed: int, index: int, height: int, width: int) -> np.ndarray:
    return np.random.default_rng([seed, index]).integers(0, 256, (height, width), dtype=np.uint8)


def pair_pool(spec: dict, workers: int = 0) -> list[str]:
    """The paths of the pool of ``spec["files"]`` pair PNGs of ``spec["width"]``
    x ``spec["height"]`` under ``CACHE``, written on first use."""
    n, w, h, seed = spec["files"], spec["width"], spec["height"], spec["seed"]
    final = os.path.join(CACHE, f"pairs-{w}x{h}-{n}-seed{seed}")
    paths = [os.path.join(final, f"{i:05d}.png") for i in range(n)]
    if os.path.isdir(final):
        return paths
    partial = final + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(partial)

    def write(i: int) -> None:
        with open(os.path.join(partial, f"{i:05d}.png"), "wb") as f:
            f.write(encode_grey(pair_pixels(seed, i, h, w), spec["zlib_level"]))

    with ThreadPoolExecutor(max_workers=workers or os.cpu_count() or 1) as ex:
        list(ex.map(write, range(n)))   # re-raises a failed write
    os.replace(partial, final)
    return paths


def split(paths: list[str], n_train: int, n_val: int, seed: int) -> tuple[list, list]:
    """(train, val) file lists: a seeded permutation of the pool."""
    perm = np.random.default_rng(np.random.SeedSequence([seed, 2])).permutation(len(paths))
    return [paths[i] for i in perm[:n_train]], [paths[i] for i in perm[n_train:n_train + n_val]]
