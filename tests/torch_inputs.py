"""Seeded numpy inputs, a PNG writer and the thread budget shared by the
port's tests. Imports no jax, so the card-side kernel tests can use it
where jax is absent."""

import os
import struct
import zlib

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


# ------------------------------------------------------------------ PNG files

PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # samples per pixel of each colour type
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))   # x0, y0, dx, dy of each pass


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_chunk(kind: bytes, data: bytes) -> bytes:
    """One chunk: length, type, data and CRC."""
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _packed_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, s) integer samples as (h, row bytes) uint8: big-endian at 16
    bits, packed most significant bit first below 8."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(row: np.ndarray, prior: np.ndarray, bpp: int, kind: int) -> bytes:
    """One row under filter ``kind`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    x, b = row.astype(np.int32), prior.astype(np.int32)
    a, c = np.zeros_like(x), np.zeros_like(b)   # the bytes bpp to the left, in this row and above
    a[bpp:], c[bpp:] = x[:-bpp], b[:-bpp]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()


def write_png(path: str, samples: np.ndarray, *, color: int, depth: int, filters=(0,),
              interlace: bool = False, idat_chunks: int = 1, palette=None,
              trns: bytes = None) -> str:
    """Write (H, W, samples) integer ``samples`` as a PNG of colour type
    ``color`` and bit depth ``depth``, with numpy, zlib and struct only:
    row r of each pass filtered by ``filters[r % len(filters)]``, Adam7 when
    ``interlace``, the zlib stream cut into ``idat_chunks`` IDAT chunks,
    ``palette`` ((K, 3) uint8) as PLTE and ``trns`` as tRNS."""
    h, w = samples.shape[:2]
    bpp = max(1, PNG_SAMPLES[color] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _packed_rows(sub, depth)
        prior = np.zeros(rows.shape[1], np.uint8)
        for r, row in enumerate(rows):
            raw += _filtered(row, prior, bpp, filters[r % len(filters)])
            prior = row
    stream = zlib.compress(raw, 9)
    cut = np.linspace(0, len(stream), idat_chunks + 1).astype(int)
    body = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        body += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += png_chunk(b"tRNS", trns)
    body += png_chunk(b"tEXt", b"Comment\x00an ancillary chunk, skipped")
    body += b"".join(png_chunk(b"IDAT", stream[lo:hi]) for lo, hi in zip(cut[:-1], cut[1:]))
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + body + png_chunk(b"IEND", b""))
    return path
