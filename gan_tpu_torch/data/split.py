"""Directory listing (counterpart of gan_tpu/data/split.py ``list_images``)."""

from __future__ import annotations

import os


def list_images(directory: str) -> list[str]:
    """Filenames containing 'png' or 'jpg' — a substring match, not an
    extension match, as in the reference."""
    return [i for i in os.listdir(directory) if "png" in i or "jpg" in i]
