"""Directory listing and CycleGAN's seeded split (counterpart of
gan_tpu/data/split.py ``list_images`` and ``cyclegan_split``). The split makes
the reference's ``random.seed`` / ``random.sample`` calls in the same order,
so one directory listing gives the same file→subset assignment."""

from __future__ import annotations

import math
import os
import random


def list_images(directory: str) -> list[str]:
    """Filenames containing 'png' or 'jpg' — a substring match, not an
    extension match, as in the reference."""
    return [i for i in os.listdir(directory) if "png" in i or "jpg" in i]


def cyclegan_split(contents_x: list[str], contents_y: list[str], *, seed: int,
                   test_img: int, validation_size: float):
    """(train_X, train_Y, val_X, val_Y, test): test drawn from X only,
    ceil((|X| − test)·val_size) val_X, ceil(|Y|·val_size) val_Y."""
    random.seed(seed)
    test = random.sample(contents_x, test_img)
    val_obs_x = math.ceil((len(contents_x) - test_img) * validation_size)
    val_obs_y = math.ceil(len(contents_y) * validation_size)
    val_x = random.sample([i for i in contents_x if i not in test], int(val_obs_x))
    val_y = random.sample(list(contents_y), int(val_obs_y))
    train_x = [i for i in contents_x if i not in test and i not in val_x]
    train_y = [i for i in contents_y if i not in val_y]
    return train_x, train_y, val_x, val_y, test
