"""Run-directory layout and logging redirect (counterpart of gan_tpu/utils/outputs.py).

    <output>/YYYY-MM-DD-HHhMM/
        logs/Log.txt            (stdout+stderr redirect when --logging true)
        logs/config.json
        logs/train_metrics.json, logs/val_metrics.json   (train mode)
        figs/<title>.png        (one per loss key)
        test_images/epoch_{N}.png
        final_test_imgs/img{N}.png
        training_checkpoints/<epoch>/
        prediction_images/img{N}.png                     (predict mode)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from datetime import datetime


@dataclasses.dataclass(frozen=True)
class RunDirs:
    root: str        # <output>/<timestamp>
    logs: str

    @property
    def checkpoints(self) -> str:
        return os.path.join(self.root, "training_checkpoints")

    @property
    def figs(self) -> str:
        return os.path.join(self.root, "figs")

    @property
    def final_test_imgs(self) -> str:
        return os.path.join(self.root, "final_test_imgs")


def make_run_dirs(output: str, *, timestamp: str | None = None) -> RunDirs:
    """<output>/YYYY-MM-DD-HHhMM; a same-minute rerun reuses the directory."""
    ts = timestamp or datetime.now().strftime("%Y-%m-%d-%Hh%M")
    root = os.path.join(output, ts)
    logs = os.path.join(root, "logs")
    os.makedirs(logs, exist_ok=True)
    return RunDirs(root=root, logs=logs)


def redirect_logging(dirs: RunDirs) -> None:
    """stdout+stderr -> logs/Log.txt, line-buffered so ``tail -f`` works."""
    f = open(os.path.join(dirs.logs, "Log.txt"), "w", buffering=1)
    sys.stdout = f
    sys.stderr = f


def silence() -> None:
    """stdout -> os.devnull: a data-parallel replica other than rank 0 prints
    nothing (its errors still reach stderr)."""
    sys.stdout = open(os.devnull, "w")


def dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
