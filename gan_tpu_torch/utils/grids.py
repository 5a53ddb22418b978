"""Prediction image grids (counterpart of gan_tpu/utils/grids.py): 2- or
3-panel figures, pixels rescaled ``·0.5 + 0.5``, gray colormap when
channels == '1', saved at dpi 200. matplotlib is imported on first use."""

from __future__ import annotations

import numpy as np

_TITLES_3 = ("Input Image", "Ground Truth", "Predicted Image")
_TITLES_2 = ("Input Image", "Predicted Image")


def save_image_grid(images, path_filename: str, *, channels: str) -> None:
    """images: sequence of 2 or 3 (H, W, C) arrays in [-1, 1]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = [np.asarray(im, dtype=np.float32) for im in images]
    titles = _TITLES_3 if len(images) == 3 else _TITLES_2
    plt.figure(figsize=(15, 6) if len(images) == 3 else (12, 6))
    for i, (im, title) in enumerate(zip(images, titles)):
        plt.subplot(1, len(images), i + 1)
        plt.title(title)
        disp = np.clip(im * 0.5 + 0.5, 0.0, 1.0)
        if channels == "1":
            plt.imshow(disp[..., 0], cmap=plt.get_cmap("gray"))
        else:
            plt.imshow(disp)
        plt.axis("off")
        plt.tight_layout()
    plt.savefig(path_filename, dpi=200)
    plt.close()
