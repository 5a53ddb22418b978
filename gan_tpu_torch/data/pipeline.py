"""Host-side decode + deterministic resize into CycleGAN's uint8 caches
(counterpart of gan_tpu/data/decode.py, gan_tpu/data/pipeline.py
``build_cyclegan_cache`` and gan_tpu/ops/resize.py ``resize_nearest_np``).

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


def build_cyclegan_cache(paths: list[str], *, img_size: int, channels: int,
                         train: bool = False, workers: int = 16) -> np.ndarray:
    """(N, S', S', C) uint8: decode, then nearest-resize to ``img_size``; for
    ``train``, resize again to S' = img_size + 30, the reference's jitter
    pre-resize, so the device augment only crops and mirrors."""
    size = img_size + JITTER_PAD if train else img_size

    def one(path):
        img = resize_nearest_np(decode_image(path, channels), img_size, img_size)
        return resize_nearest_np(img, size, size) if train else img

    if not paths:
        return np.zeros((0, size, size, channels), np.uint8)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return np.stack(list(ex.map(one, paths)))
