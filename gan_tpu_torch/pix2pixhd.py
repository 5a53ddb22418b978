"""pix2pixHD CLI of the port (NVIDIA/pix2pixHD, ``--netG global``,
``label2city_512p``): train and predict.

    python -m gan_tpu_torch.pix2pixhd --dataroot CITYSCAPES --output OUT --train --epochs 200 \\
        --vgg_weights vgg19.pth [--loadSize 1024] [--batchSize 1] [--dtype bf16]
    python -m gan_tpu_torch.pix2pixhd --dataroot CITYSCAPES --output OUT --predict --weights RUN

``--dataroot`` holds pix2pixHD's Cityscapes layout: ``{phase}_label/``
(label ids, 8-bit gray PNGs), ``{phase}_inst/`` (instance ids, 16-bit gray
PNGs; not read under ``--no_instance``) and ``{phase}_img/`` (RGB),
matched by sorted order; ``--phase`` is ``train`` for ``--train`` and
``test`` for ``--predict`` unless given (``test_img/`` may be absent: the
grids then show no image). Files are decoded by the native decoder
(gan_tpu_torch.data.native; ``GAN_TPU_NATIVE=0``: PIL) and every map is
nearest-resized to width ``--loadSize`` and the height that keeps the
first label map's aspect, each rounded to a multiple of
2^n_downsample_global (pix2pixHD's ``scale_width``; it resizes the images
bicubically, the port nearest).

The VGG loss needs ImageNet's VGG19: ``--vgg_weights`` is a torchvision
``vgg19`` state dict (``torch.save(torchvision.models.vgg19(weights=...)
.state_dict(), path)``, made wherever torchvision and the weights are).
Training with the VGG loss and no ``--vgg_weights`` is refused; nothing is
downloaded. ``--no_vgg_loss`` trains without it.

The output tree is the other CLIs': ``<output>/<timestamp>/`` with
``logs/config.json``; in train mode the seeded split of ``{phase}_*`` into
train, val (``--validation-size``) and ``--test-img`` test rows,
``logs/{train,val}_metrics.json`` (pix2pixHD's five losses), 5 ``figs/
pix2pixHD *.png``, ``test_images/epoch_{N}.png`` every 5 epochs,
``final_test_imgs/img{N}.png`` (label map, image, prediction) and
``training_checkpoints/<epoch>/``; in predict mode
``prediction_images/img{N}.png``. ``--resume RUN``, ``--checkpoint-every
N``, ``--host-cache`` and ``--device-cache`` and the fault fence (exit 17
with ``Resume with the original flags plus: --resume <run>``) are the other
CLIs'. It trains on one device: pix2pixHD's data parallelism is not ported.
"""

from __future__ import annotations

import os
import sys

from gan_tpu_torch.config import Pix2PixHDConfig, parse_pix2pixhd
from gan_tpu_torch.data import native
from gan_tpu_torch.data.loader import host_or_file_cache
from gan_tpu_torch.data.pipeline import hd_size, pix2pixhd_rows
from gan_tpu_torch.data.split import list_images, pix2pix_split
from gan_tpu_torch.device import default_device
from gan_tpu_torch.parallel import Replicas
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.pix2pixhd_trainer import Pix2PixHDTrainer
from gan_tpu_torch.train.recovery import TrainingFault, exit_for_resume
from gan_tpu_torch.utils import dump_json, make_run_dirs, redirect_logging, write_loss_figs


def triples(cfg: Pix2PixHDConfig, phase: str) -> list[tuple]:
    """(label, instance, image) paths of ``phase``, by sorted order in each
    folder; the instance None under ``--no_instance``, the image None where
    ``{phase}_img/`` is absent (predict)."""
    def listed(kind, required):
        d = os.path.join(cfg.dataroot, f"{phase}_{kind}")
        if not os.path.isdir(d):
            if required:
                raise SystemExit(f"No folder {d}: --dataroot holds {phase}_label/, "
                                 f"{phase}_inst/ and {phase}_img/ (pix2pixHD's Cityscapes layout)")
            return None
        return [os.path.join(d, n) for n in sorted(list_images(d))]

    labels = listed("label", True)
    if not labels:
        raise SystemExit("No images found in data directory!")
    insts = None if cfg.no_instance else listed("inst", True)
    imgs = listed("img", cfg.train)
    for kind, found in (("inst", insts), ("img", imgs)):
        if found is not None and len(found) != len(labels):
            raise SystemExit(f"{phase}_{kind}/ holds {len(found)} images, {phase}_label/ "
                             f"{len(labels)}")
    return [(labels[i], None if insts is None else insts[i], None if imgs is None else imgs[i])
            for i in range(len(labels))]


def main(cfg: Pix2PixHDConfig) -> None:
    if cfg.train and not cfg.no_vgg_loss and not cfg.vgg_weights:
        raise SystemExit("Training with the VGG loss needs ImageNet's VGG19: pass --vgg_weights "
                         "PATH (a torchvision vgg19 state dict; nothing is downloaded), or "
                         "--no_vgg_loss to train without it.")
    run(cfg, Replicas(device=default_device()))


def run(cfg: Pix2PixHDConfig, replicas: Replicas) -> None:
    dirs = make_run_dirs(cfg.output)
    if cfg.logging == "true":
        redirect_logging(dirs)
    phase = cfg.phase or ("train" if cfg.train else "test")
    files = triples(cfg, phase)
    height, width = hd_size(files[0][0], cfg.load_size, 1 << cfg.n_downsample_global)

    trainer = Pix2PixHDTrainer(cfg, replicas)
    cfg.dump(os.path.join(dirs.logs, "config.json"))
    print(f"\nReading in and processing images: {len(files)} rows of {height}x{width}.\n",
          flush=True)

    def cache(subset, allow_stream=False):
        rows = pix2pixhd_rows(height=height, width=width, threads=native.default_threads())
        return host_or_file_cache(subset, rows, cfg.batch_size,
                                  cfg.host_cache if allow_stream else "on")

    if cfg.predict:
        mgr = CheckpointManager(latest_checkpoint_dir(cfg.weights))
        trainer.load_state(mgr.restore(map_location="cpu"))   # load_state copies to the device
        trainer.predict(cache(files, allow_stream=True), dirs.root,
                        with_image=files[0][2] is not None)

    if cfg.train:
        if trainer.vgg is not None:
            trainer.load_vgg(cfg.vgg_weights)
        by_name = {t[0]: t for t in files}
        train, val, test = (
            [by_name[n] for n in names] for names in pix2pix_split(
                [t[0] for t in files], seed=cfg.seed, test_img=cfg.test_img,
                validation_size=cfg.validation_size))
        train_cache = cache(train, allow_stream=True)
        val_cache = cache(val, allow_stream=True)
        test_cache = cache(test)   # small: always in memory

        manager = (CheckpointManager(dirs.checkpoints, max_to_keep=1)
                   if cfg.save_weights == "true" else None)
        start_epoch = 0
        if cfg.resume:
            src = CheckpointManager(latest_checkpoint_dir(cfg.resume))
            start_epoch = src.latest_epoch() or 0
            trainer.load_state(src.restore(map_location="cpu"))
            print(f"Resumed from {cfg.resume} at epoch {start_epoch}", flush=True)
        try:
            train_metrics, val_metrics = trainer.fit(train_cache, val_cache, test_cache, dirs.root,
                                                     checkpoint_manager=manager,
                                                     start_epoch=start_epoch)
        except TrainingFault as fault:   # the fence could not rewind: resume in a new process
            exit_for_resume(fault, dirs.root)
        os.makedirs(dirs.final_test_imgs, exist_ok=True)
        for i in range(test_cache.shape[0]):
            trainer.generate_image(test_cache[i:i + 1],
                                   os.path.join(dirs.final_test_imgs, f"img{i}.png"))
        dump_json(train_metrics, os.path.join(dirs.logs, "train_metrics.json"))
        dump_json(val_metrics, os.path.join(dirs.logs, "val_metrics.json"))
        write_loss_figs(train_metrics, val_metrics, prefix="pix2pixHD ", output_path=dirs.figs)

    print("Done.")


if __name__ == "__main__":
    main(parse_pix2pixhd(sys.argv[1:]))
