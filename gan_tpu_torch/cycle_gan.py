"""CycleGAN CLI of the port — the predict mode of cycle_gan.py.

    python -m gan_tpu_torch.cycle_gan --input-images DIR --output OUT \\
        --predict --weights RUN_DIR [--img-size 256] [--channels 1] [--dtype bf16]

gan_tpu's flags (gan_tpu_torch.config.parse_cyclegan), the same run directory
and ``logs/config.json``, and ``prediction_images/img{N}.png``. ``--weights``
points at a run (or ``training_checkpoints/``) holding the port's torch
checkpoints. ``--train`` is not ported yet and exits with an error;
``--use-pallas``, ``--host-cache``, ``--num-devices`` and the other
training/TPU flags are parsed and written to config.json but change nothing
here: instance norm always runs the CUDA kernel on the card.
"""

from __future__ import annotations

import os
import sys

from gan_tpu_torch.config import CycleGANConfig, parse_cyclegan
from gan_tpu_torch.data.pipeline import build_cyclegan_cache
from gan_tpu_torch.data.split import list_images
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.utils import make_run_dirs, redirect_logging


def main(cfg: CycleGANConfig) -> None:
    if cfg.train:
        raise SystemExit("gan_tpu_torch: --train is not ported yet; "
                         "train with cycle_gan.py (gan_tpu)")
    dirs = make_run_dirs(cfg.output)
    if cfg.logging == "true":
        redirect_logging(dirs)

    trainer = CycleGANTrainer(cfg)
    cfg.dump(os.path.join(dirs.logs, "config.json"))

    print("\nReading in and processing images.\n", flush=True)
    contents_x = list_images(cfg.input_images)
    if not contents_x:
        raise SystemExit("No images found in input image directory!")
    predict_cache = build_cyclegan_cache(
        [os.path.join(cfg.input_images, n) for n in contents_x],
        img_size=cfg.img_size, channels=cfg.n_channels)
    mgr = CheckpointManager(latest_checkpoint_dir(cfg.weights))
    trainer.load_state(mgr.restore(map_location=trainer.device))
    trainer.predict(predict_cache, dirs.root,
                    raw=cfg.raw_predictions == "true", raw_names=contents_x)
    print("Done.")


if __name__ == "__main__":
    main(parse_cyclegan(sys.argv[1:]))
