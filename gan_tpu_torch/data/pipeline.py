"""Host-side decode + deterministic resize into the uint8 caches
(counterpart of gan_tpu/data/decode.py, gan_tpu/data/pipeline.py
``split_pair``, ``build_pix2pix_cache`` and ``build_cyclegan_cache``, and
gan_tpu/ops/resize.py ``resize_nearest_np``).

A :class:`Rows` is one split's per-file work (decode, split, resize) over a
list of files. By default it is one call of the native decoder
(:mod:`gan_tpu_torch.data.native`, the port of gan_tpu's native loader: PNG
over zlib, on C++ threads, off the GIL). ``pix2pix_rows``,
``cyclegan_rows`` and ``pix2pixhd_rows`` (whose "files" are (label,
instance, image) triples) make the CLIs' rows, the ``build_*_cache`` functions
decode a whole split with them, and a
:class:`~gan_tpu_torch.data.loader.FileCache` calls them once per batch.

``decode_image``, ``pix2pix_sample``, ``cyclegan_sample`` and
``pix2pixhd_sample`` are the plain
per-file twins over PIL: a :class:`Rows` sends JPEG files through them one
at a time (the native decoder reads PNG only), and ``GAN_TPU_NATIVE=0``
sends every file, on a pool of ``DECODE_WORKERS`` threads.

PIL is imported inside :func:`decode_image`, so the package imports without it.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from gan_tpu_torch.data import native
from gan_tpu_torch.data.augment import JITTER_PAD

DECODE_WORKERS = 16   # the PIL twin's threads per call (gan_tpu's pool width)


def decode_image(path: str, channels: int) -> np.ndarray:
    """Decode an image file to uint8 (H, W, C); 1 -> grayscale (PIL luma), 3 -> RGB.

    16-bit gray (PIL's ``I;16`` modes, or ``I`` from a PNG in older Pillow)
    keeps the high byte of each sample, as gan_tpu's default (native) path
    does: PIL's ``convert`` would clip it to 255."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode.startswith("I;16") or (im.mode == "I" and im.format == "PNG"):
            gray = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)[:, :, None]
            return gray if channels == 1 else np.repeat(gray, 3, axis=2)
        arr = np.asarray(im.convert("L" if channels == 1 else "RGB"), dtype=np.uint8)
    return arr[:, :, None] if channels == 1 else arr


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    idx = np.floor((np.arange(out_size) + 0.5) * scale).astype(np.int32)
    return np.minimum(idx, in_size - 1)


def resize_nearest_np(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """TF2 ``tf.image.resize(NEAREST)`` of (..., H, W, C): half-pixel centers,
    ``src = floor((dst + 0.5) * in/out)`` clamped to ``in - 1``."""
    in_h, in_w = image.shape[-3], image.shape[-2]
    if (in_h, in_w) == (height, width):
        return image
    rows = _nearest_indices(in_h, height)
    cols = _nearest_indices(in_w, width)
    return image[..., rows[:, None], cols[None, :], :]


def split_pair(image: np.ndarray, orient: str) -> tuple[np.ndarray, np.ndarray]:
    """(input, target) halves of a side-by-side pair, split at W // 2;
    ``orient`` 'left' puts the input on the left."""
    w = image.shape[1] // 2
    left, right = image[:, :w, :], image[:, w:, :]
    return (left, right) if orient == "left" else (right, left)


def pix2pix_sample(path: str, *, img_size: int, channels: int, orient: str,
                   train: bool = False) -> np.ndarray:
    """(2, S', S', C) uint8, axis 0 = (input, target): decode, split, and
    nearest-resize each half to S' = img_size + 30 for ``train`` (the
    reference's jitter pre-resize), img_size otherwise."""
    size = img_size + JITTER_PAD if train else img_size
    inp, tar = split_pair(decode_image(path, channels), orient)
    return np.stack([resize_nearest_np(inp, size, size), resize_nearest_np(tar, size, size)])


def cyclegan_sample(path: str, *, img_size: int, channels: int,
                    train: bool = False) -> np.ndarray:
    """(S', S', C) uint8: decode, then nearest-resize to ``img_size``; for
    ``train``, resize again to S' = img_size + 30, the reference's jitter
    pre-resize, so the device augment only crops and mirrors."""
    img = resize_nearest_np(decode_image(path, channels), img_size, img_size)
    return resize_nearest_np(img, img_size + JITTER_PAD, img_size + JITTER_PAD) if train else img


def decode_ids(path: str) -> np.ndarray:
    """A gray instance map's ids, uint32 (H, W): 16-bit samples whole."""
    from PIL import Image

    with Image.open(path) as im:
        if not (im.mode in ("L", "I") or im.mode.startswith("I;16")):
            raise ValueError(f"{path}: an instance map is a gray PNG, not mode {im.mode}")
        return np.asarray(im).astype(np.uint32) & 0xFFFF


def pix2pixhd_sample(triple: tuple, *, height: int, width: int) -> np.ndarray:
    """(height, width, 6) uint8: pix2pixHD's row of a (label, instance,
    image) triple, each map nearest-resized to (height, width):
    (label id, instance id's high byte, its low byte, R, G, B); a missing
    instance map or image leaves its channels 0. (pix2pixHD resizes the image
    bicubically; here every map is resized nearest, as the native decoder
    does.)"""
    label, inst, img = triple
    out = np.zeros((height, width, 6), np.uint8)
    out[..., :1] = resize_nearest_np(decode_image(label, 1), height, width)
    if inst is not None:
        ids = resize_nearest_np(decode_ids(inst)[..., None], height, width)[..., 0]
        out[..., 1], out[..., 2] = ids >> 8, ids & 0xFF
    if img is not None:
        out[..., 3:] = resize_nearest_np(decode_image(img, 3), height, width)
    return out


def hd_size(label_path: str, load_size: int, base: int) -> tuple[int, int]:
    """pix2pixHD's ``scale_width`` and ``make_power_2`` of the first label
    map: width ``load_size``, the height that keeps its aspect, each rounded
    to a multiple of ``base`` (2^n_downsample_global)."""
    h, w = native.png_size(label_path)
    if not (h and w):
        raise ValueError(f"{label_path}: not a PNG whose size can be read")
    height = int(load_size * h / w)
    return (max(base, int(round(height / base) * base)),
            max(base, int(round(load_size / base) * base)))


def decode_all(paths: Sequence[str], sample: Callable[[str], np.ndarray], out: np.ndarray,
               workers: int = DECODE_WORKERS) -> np.ndarray:
    """``out[i] = sample(paths[i])`` for every path, on a pool of
    ``workers`` threads (in the calling thread for 1); returns ``out``."""
    if workers <= 1 or len(paths) <= 1:
        for i, p in enumerate(paths):
            out[i] = sample(p)
        return out
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for i, row in enumerate(ex.map(sample, paths)):
            out[i] = row
    return out


class Rows:
    """One split's per-file work over a list of files: ``rows(paths)`` is
    the (N, *shape) uint8 array of ``sample(path)`` for each path, written
    into ``out`` when given.

    With ``native_batch`` (``native.load_pair_batch`` or
    ``load_single_batch`` with its settings bound), the files are decoded by one native call on
    ``threads`` C++ threads (None: ``native.default_threads()``), with no
    GIL held; JPEG files, which it refuses, then go through ``sample`` one
    at a time, and ``jpeg_files`` counts them. Without ``native_batch``, or
    under ``GAN_TPU_NATIVE=0``, every file goes through ``sample`` on a
    pool of ``workers`` threads. Either way the rows are the same bytes."""

    def __init__(self, sample: Callable[[str], np.ndarray], shape: tuple,
                 native_batch: Optional[Callable] = None, *, workers: int = DECODE_WORKERS,
                 threads: Optional[int] = None):
        self.sample = sample
        self.shape = tuple(shape)
        self.native_batch = native_batch
        self.workers = workers
        self.threads = threads
        self.jpeg_files = 0
        self._lock = threading.Lock()   # a FileCache's producer and the main thread may both call

    def __call__(self, paths: Sequence[str], out: Optional[np.ndarray] = None) -> np.ndarray:
        paths = list(paths)
        if out is None:
            out = np.empty((len(paths), *self.shape), np.uint8)
        if self.native_batch is None or not native.enabled():
            return decode_all(paths, self.sample, out, self.workers)
        _, jpegs = self.native_batch(paths, out=out, threads=self.threads)
        for i in jpegs:
            out[i] = self.sample(paths[i])
        if jpegs:
            with self._lock:
                self.jpeg_files += len(jpegs)
        return out


def pix2pix_rows(*, img_size: int, channels: int, orient: str, train: bool = False,
                 **kw) -> Rows:
    """:class:`Rows` of :func:`pix2pix_sample`: (2, S', S', C) per pair file."""
    size = img_size + JITTER_PAD if train else img_size
    return Rows(functools.partial(pix2pix_sample, img_size=img_size, channels=channels,
                                  orient=orient, train=train),
                (2, size, size, channels),
                functools.partial(native.load_pair_batch, channels=channels, orient=orient,
                                  size=size), **kw)


def cyclegan_rows(*, img_size: int, channels: int, train: bool = False, **kw) -> Rows:
    """:class:`Rows` of :func:`cyclegan_sample`: (S', S', C) per file."""
    size = img_size + JITTER_PAD if train else img_size
    return Rows(functools.partial(cyclegan_sample, img_size=img_size, channels=channels,
                                  train=train),
                (size, size, channels),
                functools.partial(native.load_single_batch, channels=channels,
                                  img_size=img_size, out_size=size), **kw)


def pix2pixhd_rows(*, height: int, width: int, **kw) -> Rows:
    """:class:`Rows` of :func:`pix2pixhd_sample`: (height, width, 6) per
    (label, instance, image) triple."""
    return Rows(functools.partial(pix2pixhd_sample, height=height, width=width),
                (height, width, 6),
                functools.partial(native.load_hd_batch, height=height, width=width), **kw)


def build_pix2pix_cache(paths: list[str], *, img_size: int, channels: int, orient: str,
                        train: bool = False, workers: int = DECODE_WORKERS) -> np.ndarray:
    """(N, 2, S', S', C) uint8: :func:`pix2pix_sample` of each path."""
    return pix2pix_rows(img_size=img_size, channels=channels, orient=orient, train=train,
                        workers=workers)(paths)


def build_cyclegan_cache(paths: list[str], *, img_size: int, channels: int,
                         train: bool = False, workers: int = DECODE_WORKERS) -> np.ndarray:
    """(N, S', S', C) uint8: :func:`cyclegan_sample` of each path."""
    return cyclegan_rows(img_size=img_size, channels=channels, train=train,
                         workers=workers)(paths)
