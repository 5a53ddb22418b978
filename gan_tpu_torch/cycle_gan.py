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

``--resume RUN`` restores the whole training state of RUN's latest
checkpoint and trains its remaining epochs (the metrics hold the epochs this
run trained); ``--checkpoint-every N`` also saves every N epochs. Every
epoch runs inside gan_tpu's fault fence (gan_tpu_torch.train.recovery): an
anchor checkpoint before the first epoch (deleted by the next save), and on a
device fault (a CUDA error that leaves the context alive, out-of-memory, a
host OSError of a streamed epoch) an in-process rewind to the last
checkpoint, at most ``GAN_TPU_FAULT_RETRIES`` times (default 3; 0 turns the
fence off). When the retries run out, the context is lost (a sticky CUDA
error) or the world holds more than one rank, the run prints the fault and
``Resume with the original flags plus: --resume <run>`` and exits 17.
``--host-cache off`` (or ``auto`` when the decoded corpus would exceed half
of the host's available memory) streams train, val and predict batches
straight from the files through FileCaches; the test images stay in
memory. Files are decoded by the native PNG decoder
(gan_tpu_torch.data.native), JPEGs by PIL; ``GAN_TPU_NATIVE=0`` decodes
every file with PIL. ``--device-cache off`` (or ``auto`` when the caches exceed 0.4 of
the card's memory) keeps decoded caches on the host and streams their
batches to the card each step. Either way the epochs equal the resident
ones. ``--remat on`` checkpoints every U-Net block of the
generator(s) while training (``torch.utils.checkpoint``; the backward
recomputes each block), and ``auto`` does so only where training would not
fit in the card's memory without it
(gan_tpu_torch.train.pix2pix_trainer.use_remat); config.json keeps the flag
as given. ``--use-pallas`` is parsed and written to config.json but
changes nothing here: the port always runs its CUDA kernels on the card,
and nor does ``--bn-cross-replica``: CycleGAN's norms are instance norms.

Data parallelism (gan_tpu_torch.parallel): ``--train --num-devices N``
trains N replicas, one process per card (one per CPU process on the CPU),
each global batch of ``--batch-size`` split over them and the gradients
averaged; the CLI spawns the N ranks itself, or under ``torchrun
--nproc-per-node N -m gan_tpu_torch.cycle_gan ...`` each process is a
rank. ``--num-devices 0`` takes every card (one process on the CPU), as
many as divide the batch. A batch that N does not divide, or an N that the
cards or torchrun's ``WORLD_SIZE`` cannot give, exits with an error. Rank 0
makes the run directory and alone writes the logs, metrics, figures,
samples and checkpoints; every rank restores ``--resume``. ``--predict``
runs on one device.
"""

from __future__ import annotations

import os
import sys

from gan_tpu_torch.config import CycleGANConfig, parse_cyclegan
from gan_tpu_torch.data import native
from gan_tpu_torch.data.loader import host_or_file_cache
from gan_tpu_torch.data.pipeline import cyclegan_rows
from gan_tpu_torch.data.split import cyclegan_split, list_images
from gan_tpu_torch.parallel import Replicas, launch
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.train.recovery import TrainingFault, exit_for_resume
from gan_tpu_torch.utils import (dump_json, make_run_dirs, redirect_logging, silence,
                                 write_loss_figs)


def main(cfg: CycleGANConfig) -> None:
    launch(run, cfg)


def run(cfg: CycleGANConfig, replicas: Replicas) -> None:
    """The CLI on one replica (all of it without data parallelism)."""
    lead = replicas.rank == 0
    dirs = replicas.broadcast(make_run_dirs(cfg.output) if lead else None)
    if not lead:
        silence()
    elif cfg.logging == "true":
        redirect_logging(dirs)

    trainer = CycleGANTrainer(cfg, replicas)
    if lead:
        cfg.dump(os.path.join(dirs.logs, "config.json"))

    print("\nReading in and processing images.\n", flush=True)
    contents_x = list_images(cfg.input_images)
    if not contents_x:
        raise SystemExit("No images found in input image directory!")

    def cache(directory, names, train, allow_stream=False):
        """A decoded uint8 host cache, or a FileCache that streams from the
        files when the decoded corpus would not fit in host memory or under
        --host-cache off (gan_tpu's cycle_gan.py). The ranks on a host share
        its cores for the decode."""
        rows = cyclegan_rows(img_size=cfg.img_size, channels=cfg.n_channels, train=train,
                             threads=native.default_threads(replicas.local_size))
        return host_or_file_cache([os.path.join(directory, n) for n in names], rows,
                                  cfg.batch_size, cfg.host_cache if allow_stream else "on")

    if cfg.predict:
        predict_cache = cache(cfg.input_images, contents_x, train=False, allow_stream=True)
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
        train_x = cache(cfg.input_images, train_x_n, train=True, allow_stream=True)
        train_y = cache(cfg.target_images, train_y_n, train=True, allow_stream=True)
        val_x = cache(cfg.input_images, val_x_n, train=False, allow_stream=True)
        val_y = cache(cfg.target_images, val_y_n, train=False, allow_stream=True)
        test_cache = cache(cfg.input_images, test_n, train=False)   # small: always in memory

        manager = (CheckpointManager(dirs.checkpoints, max_to_keep=3)
                   if cfg.save_weights == "true" and lead else None)
        start_epoch = 0
        if cfg.resume:   # on every rank
            src = CheckpointManager(latest_checkpoint_dir(cfg.resume))
            start_epoch = src.latest_epoch() or 0
            trainer.load_state(src.restore(map_location="cpu"))
            print(f"Resumed from {cfg.resume} at epoch {start_epoch}", flush=True)
        try:
            train_metrics, val_metrics = trainer.fit(train_x, train_y, val_x, val_y, test_cache,
                                                     dirs.root, checkpoint_manager=manager,
                                                     start_epoch=start_epoch)
        except TrainingFault as fault:   # the fence could not rewind: resume in a new process
            exit_for_resume(fault, dirs.root, lead)
        if lead:
            os.makedirs(dirs.final_test_imgs, exist_ok=True)
            test_norm = test_cache.astype("float32") / 127.5 - 1.0
            for i in range(test_norm.shape[0]):
                trainer.generate_image(test_norm[i:i + 1],
                                       os.path.join(dirs.final_test_imgs, f"img{i}.png"),
                                       key_index=i)
            dump_json(train_metrics, os.path.join(dirs.logs, "train_metrics.json"))
            dump_json(val_metrics, os.path.join(dirs.logs, "val_metrics.json"))
            write_loss_figs(train_metrics, val_metrics, prefix="CycleGAN ",
                            output_path=dirs.figs)

    print("Done.")


if __name__ == "__main__":
    main(parse_cyclegan(sys.argv[1:]))
