"""The reference's host path for a pair file: a plain PNG decoder (numpy and
zlib) for 8-bit greyscale, non-interlaced images, the side-by-side split,
and TF2's nearest-neighbour resize with half-pixel centres, as
kingjosephm/GAN's ``tf.image.resize(NEAREST)`` reads the corpus."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(kind: int, row: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """One scanline of 1 byte per pixel."""
    if kind == 0:
        return row
    if kind == 1:
        return (np.cumsum(row, dtype=np.int64) & 0xFF).astype(np.uint8)
    if kind == 2:
        return (row.astype(np.int64) + prior).astype(np.uint8)
    out = np.zeros_like(row)
    left = 0
    for i in range(row.shape[0]):
        up = int(prior[i])
        corner = int(prior[i - 1]) if i else 0
        if kind == 3:
            pred = (left + up) // 2
        elif kind == 4:
            p = left + up - corner
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - corner)
            pred = left if pa <= pb and pa <= pc else (up if pb <= pc else corner)
        else:
            raise ValueError(f"unknown PNG filter {kind}")
        left = (int(row[i]) + pred) & 0xFF
        out[i] = left
    return out


def decode_grey(path: str) -> np.ndarray:
    """(H, W) uint8 pixels of an 8-bit greyscale PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _c, _f, interlace = header
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit grey, non-interlaced PNGs are read here")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    out = np.empty((h, w), np.uint8)
    prior = np.zeros(w, np.uint8)
    for r in range(h):
        prior = out[r] = _unfilter(int(raw[r, 0]), raw[r, 1:], prior)
    return out


def nearest(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, ...) -> (height, width, ...): src = floor((dst + 0.5) * in / out),
    clamped to in - 1."""
    def idx(n_in, n_out):
        return np.minimum(np.floor((np.arange(n_out) + 0.5) * (n_in / n_out)).astype(np.int64),
                          n_in - 1)
    return image[idx(image.shape[0], height)[:, None], idx(image.shape[1], width)[None, :]]


def pair_row(path: str, size: int) -> np.ndarray:
    """(2, size, size, 1) uint8: the left half (input) and the right half
    (target) of a side-by-side pair file, each resized to size²."""
    img = decode_grey(path)
    half = img.shape[1] // 2
    return np.stack([nearest(img[:, :half], size, size),
                     nearest(img[:, half:], size, size)])[..., None]
