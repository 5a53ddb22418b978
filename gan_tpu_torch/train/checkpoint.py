"""Checkpoints as torch state files (counterpart of gan_tpu/train/checkpoint.py).

The tree is gan_tpu's: ``training_checkpoints/<epoch>/``, the oldest epochs
pruned beyond ``max_to_keep``, the latest restored. Each epoch directory holds
one ``state.pt``: a nested dict of tensors, loaded with ``weights_only=True``.
gan_tpu's orbax checkpoints are not readable here: an epoch directory without
a ``state.pt`` raises, naming ``tools/convert_gan_tpu_checkpoint.py``, which
turns a gan_tpu run into a checkpoint of the port.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

_STATE_FILE = "state.pt"


class CheckpointManager:
    """save(epoch, state) / latest_epoch() / restore()."""

    def __init__(self, directory: str, *, max_to_keep: int = 1):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._anchor: Optional[int] = None   # the epoch of an anchor save not yet deleted

    def all_epochs(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        epochs = sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())
        foreign = [e for e in epochs
                   if not os.path.isfile(os.path.join(self.directory, str(e), _STATE_FILE))]
        if foreign:
            raise ValueError(
                f"{self.directory} holds epoch directories without {_STATE_FILE} "
                f"({', '.join(map(str, foreign))}): a gan_tpu (orbax) checkpoint? Convert "
                "the run with tools/convert_gan_tpu_checkpoint.py first")
        return epochs

    def save(self, epoch: int, state: Any, *, anchor: bool = False) -> None:
        """Write ``<dir>/<epoch>/state.pt`` (via a temp dir and a rename, so a
        reader never sees half a checkpoint), then prune to ``max_to_keep``."""
        final = os.path.join(self.directory, str(epoch))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)   # and the checkpoint root, on the first save
        torch.save(state, os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_epochs()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        if anchor:
            self._anchor = epoch
        elif self._anchor is not None and epoch != self._anchor:
            shutil.rmtree(os.path.join(self.directory, str(self._anchor)), ignore_errors=True)
            self._anchor = None

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None, *, map_location=None) -> Any:
        """Load the given (default: latest) epoch's state."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(os.path.join(self.directory, str(epoch), _STATE_FILE),
                          map_location=map_location, weights_only=True)


def latest_checkpoint_dir(weights_path: str) -> str:
    """Resolve ``--weights``: a checkpoint root (``training_checkpoints/``) or
    a run dir containing one."""
    cand = os.path.join(weights_path, "training_checkpoints")
    return cand if os.path.isdir(cand) else weights_path
