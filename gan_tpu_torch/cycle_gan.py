"""CycleGAN CLI of the port (counterpart of cycle_gan.py): train and predict.

    python -m gan_tpu_torch.cycle_gan --input-images X --target-images Y \\
        --output OUT --train --epochs 5 [--img-size 256] [--batch-size 8] [--dtype bf16]
    python -m gan_tpu_torch.cycle_gan --input-images X --output OUT \\
        --predict --weights RUN_DIR [--img-size 256] [--channels 1] [--dtype bf16]

gan_tpu's flags (gan_tpu_torch.config.parse_cyclegan) and output tree: the
run directory with ``logs/config.json``; in train mode the seeded split,
``logs/{train,val}_metrics.json``, 7 ``figs/CycleGAN *.png``,
``test_images/epoch_{N}.png`` every 5 epochs, ``final_test_imgs/img{N}.png``
and ``training_checkpoints/<epoch>/`` (the last 3); in predict mode
``prediction_images/img{N}.png``. ``--weights`` points at a run (or
``training_checkpoints/``) holding the port's torch checkpoints.

``--resume``, ``--checkpoint-every`` and ``--num-devices`` > 1 are not ported
yet: with ``--train`` they exit with an error. ``--use-pallas``,
``--host-cache``, ``--device-cache``, ``--remat`` and ``--bn-cross-replica``
are parsed and written to config.json but change nothing here: instance norm
always runs the CUDA kernels on the card, and the caches always live on it.
"""

from __future__ import annotations

import os
import sys

from gan_tpu_torch.config import CycleGANConfig, parse_cyclegan
from gan_tpu_torch.data.pipeline import build_cyclegan_cache
from gan_tpu_torch.data.split import cyclegan_split, list_images
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.utils import dump_json, make_run_dirs, redirect_logging, write_loss_figs


def _refuse_unported(cfg: CycleGANConfig) -> None:
    unported = [flag for flag, on in (("--resume", cfg.resume),
                                      ("--checkpoint-every", cfg.checkpoint_every),
                                      ("--num-devices > 1", cfg.num_devices > 1)) if on]
    if cfg.train and unported:
        raise SystemExit(f"gan_tpu_torch: {', '.join(unported)} with --train is not "
                         "ported yet; train with cycle_gan.py (gan_tpu) or drop the flag")


def main(cfg: CycleGANConfig) -> None:
    _refuse_unported(cfg)
    dirs = make_run_dirs(cfg.output)
    if cfg.logging == "true":
        redirect_logging(dirs)

    trainer = CycleGANTrainer(cfg)
    cfg.dump(os.path.join(dirs.logs, "config.json"))

    print("\nReading in and processing images.\n", flush=True)
    contents_x = list_images(cfg.input_images)
    if not contents_x:
        raise SystemExit("No images found in input image directory!")

    def cache(directory, names, train):
        return build_cyclegan_cache([os.path.join(directory, n) for n in names],
                                    img_size=cfg.img_size, channels=cfg.n_channels, train=train)

    if cfg.predict:
        predict_cache = cache(cfg.input_images, contents_x, train=False)
        mgr = CheckpointManager(latest_checkpoint_dir(cfg.weights))
        trainer.load_state(mgr.restore(map_location="cpu"))   # load_state copies to the device
        trainer.predict(predict_cache, dirs.root,
                        raw=cfg.raw_predictions == "true", raw_names=contents_x)

    if cfg.train:
        contents_y = list_images(cfg.target_images)
        if not contents_y:
            raise SystemExit("No images found in target image directory!")
        train_x_n, train_y_n, val_x_n, val_y_n, test_n = cyclegan_split(
            contents_x, contents_y, seed=cfg.seed, test_img=cfg.test_img,
            validation_size=cfg.validation_size)
        train_x = cache(cfg.input_images, train_x_n, train=True)
        train_y = cache(cfg.target_images, train_y_n, train=True)
        val_x = cache(cfg.input_images, val_x_n, train=False)
        val_y = cache(cfg.target_images, val_y_n, train=False)
        test_cache = cache(cfg.input_images, test_n, train=False)

        manager = (CheckpointManager(dirs.checkpoints, max_to_keep=3)
                   if cfg.save_weights == "true" else None)
        train_metrics, val_metrics = trainer.fit(train_x, train_y, val_x, val_y, test_cache,
                                                 dirs.root, checkpoint_manager=manager)

        os.makedirs(dirs.final_test_imgs, exist_ok=True)
        test_norm = test_cache.astype("float32") / 127.5 - 1.0
        for i in range(test_norm.shape[0]):
            trainer.generate_image(test_norm[i:i + 1],
                                   os.path.join(dirs.final_test_imgs, f"img{i}.png"),
                                   key_index=i)
        dump_json(train_metrics, os.path.join(dirs.logs, "train_metrics.json"))
        dump_json(val_metrics, os.path.join(dirs.logs, "val_metrics.json"))
        write_loss_figs(train_metrics, val_metrics, prefix="CycleGAN ", output_path=dirs.figs)

    print("Done.")


if __name__ == "__main__":
    main(parse_cyclegan(sys.argv[1:]))
