"""Host-side decode + deterministic resize into the uint8 caches
(counterpart of gan_tpu/data/decode.py, gan_tpu/data/pipeline.py
``split_pair``, ``build_pix2pix_cache`` and ``build_cyclegan_cache``, and
gan_tpu/ops/resize.py ``resize_nearest_np``). gan_tpu's native C++ loader,
bit-identical to its Python path, is not ported.

PIL is imported inside :func:`decode_image`, so the package imports without it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gan_tpu_torch.data.augment import JITTER_PAD


def decode_image(path: str, channels: int) -> np.ndarray:
    """Decode an image file to uint8 (H, W, C); 1 -> grayscale (PIL luma), 3 -> RGB."""
    from PIL import Image

    with Image.open(path) as im:
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


def _stack(fn, paths, empty_shape, workers):
    if not paths:
        return np.zeros(empty_shape, np.uint8)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return np.stack(list(ex.map(fn, paths)))


def build_pix2pix_cache(paths: list[str], *, img_size: int, channels: int, orient: str,
                        train: bool = False, workers: int = 16) -> np.ndarray:
    """(N, 2, S', S', C) uint8, axis 1 = (input, target): decode, split, and
    nearest-resize each half to S' = img_size + 30 for ``train`` (the
    reference's jitter pre-resize), img_size otherwise."""
    size = img_size + JITTER_PAD if train else img_size

    def one(path):
        inp, tar = split_pair(decode_image(path, channels), orient)
        return np.stack([resize_nearest_np(inp, size, size), resize_nearest_np(tar, size, size)])

    return _stack(one, paths, (0, 2, size, size, channels), workers)


def build_cyclegan_cache(paths: list[str], *, img_size: int, channels: int,
                         train: bool = False, workers: int = 16) -> np.ndarray:
    """(N, S', S', C) uint8: decode, then nearest-resize to ``img_size``; for
    ``train``, resize again to S' = img_size + 30, the reference's jitter
    pre-resize, so the device augment only crops and mirrors."""
    size = img_size + JITTER_PAD if train else img_size

    def one(path):
        img = resize_nearest_np(decode_image(path, channels), img_size, img_size)
        return resize_nearest_np(img, size, size) if train else img

    return _stack(one, paths, (0, size, size, channels), workers)
