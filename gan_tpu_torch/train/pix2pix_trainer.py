"""Pix2Pix trainer (counterpart of gan_tpu/train/pix2pix_trainer.py).

It holds the reference's two networks, the batch-norm U-Net generator and
the conditional PatchGAN, and one Adam per network.

**The step** (gan_tpu_torch/train/base.py). fake = G(x), then the
discriminator on the real pair D(x, y) and on the fake pair D(x, fake), each
in its own call, so each takes its own batch-norm statistics, as gan_tpu's
separate applications do. The generator's total is adversarial + λ ·
secondary (L1 or SSIM); the discriminator's is the BCE pair · 0.5. Each
network is a gradient group of its own, ("gen",) then ("disc",), and takes
the gradient of its own total with respect to its own parameters, so the one
D(x, fake) serves both losses: the generator's gradient passes through D
without touching D's parameters, and D's stops at the fake, which is
gan_tpu's ``sg_tree`` / ``stop_gradient`` partition.

**Draws.** Per step, one dropout generator and one jitter generator, seeded
from (seed + 1, epoch, train or val, step, index), and over W > 1 replicas
from (seed + 1, epoch, train or val, step, rank, index) for a full step.

**Epochs** run in the fixed order of the split (the reference shuffles once
there): the full batches through the cached epoch runner (a CUDA graph of
the step on the card, gan_tpu's compiled epoch; train/base.py), then the
exact-size remainder as an eager step of its own (gan_tpu's
``_run_remainder``), since padding it would change the batch statistics.
The uint8 caches live whole on the device when they fit, or stream from the
host (``--device-cache off``, or a FileCache under ``--host-cache off``) in
the same order and with the same draws (train/base.py). ``fit`` resumes at
``start_epoch`` (``--resume``), saves every ``--checkpoint-every`` epochs
and runs every epoch inside gan_tpu's fault fence (train/recovery.py): a
fault rewinds to the last checkpoint in-process and the epochs re-run
exactly. gan_tpu's hybrid tier and epoch segments are not ported.

**Data parallelism** (train/base.py): over W replicas, global step s takes
rows [s·B, (s+1)·B), replica r the B / W of them that its stripe holds
(``loop.local_perm``), with per-replica batch-norm statistics, or with
``--bn-cross-replica true`` statistics over all W replicas' rows (the
``bn_group``; gan_tpu's ``bn_axis``); the remainder runs whole on every
replica with per-replica statistics, which are then the batch's. At a
per-replica batch of one, per-replica batch norm is instance norm with
batch norm's epsilon, K1 and K2 on the card.

**Predict** normalises each image with its own batch-norm statistics
(``per_sample``, K1 on the card), as the reference's one-image-at-a-time
loop does and gan_tpu's vmap over batch-1 sub-batches does; it takes an
ndarray or a FileCache.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from gan_tpu_torch.config import CycleGANConfig, Pix2PixConfig
from gan_tpu_torch.data.augment import (JITTER_PAD, jitter_draws, normalize_batch,
                                        paired_jitter_batch)
from gan_tpu_torch.data.loader import DEVICE_CACHE_FRACTION, device_bytes
from gan_tpu_torch.losses import (PIX2PIX_LOSS_KEYS, discriminator_loss, empty_losses,
                                  pix2pix_generator_loss)
from gan_tpu_torch.models import PatchGANDiscriminator, UNetGenerator
from gan_tpu_torch.parallel import Replicas, single
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.base import GANTrainer, StepDraws, Stripe, generator_depth
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.utils.grids import save_image_grid
from gan_tpu_torch.utils.profiling import span

NETWORKS = ("gen", "disc")
GRADIENT_GROUPS = (("gen",), ("disc",))
_DROPOUT, _JITTER = 0, 1   # draw indices within a step

# Peak device memory of a remat-free graph epoch, (bytes, bytes per
# 256²-image equivalent of the batch), from chip_smoke.py phase 14f's
# remat-free points on an NVIDIA H100 80GB HBM3 at a 700 W power limit, each
# read above what was allocated before its trainer was built (Pix2Pix at
# 512², batch 1, 4, 16, 64 and 256², batch 128: 1.14-12.92 GiB; CycleGAN at
# 512², batch 1, in the batched form, and 4, 16, 48, 64, 72, unbatched:
# 2.77-52.12 GiB): the least-squares slope, with the intercept raised until
# the line under-predicts no point as printed, to 0.01 GiB
REMAT_FREE_PEAK = {"pix2pix": (0.965 * 2**30, 0.0467 * 2**30),
                   "cyclegan": (2.349 * 2**30, 0.1732 * 2**30)}


def use_remat(config, device_memory: int, n_devices: int = 1) -> bool:
    """``--remat``: ``on`` and ``off`` as given; ``auto`` checkpoints the
    U-Net blocks only where training would not fit without it: where the
    remat-free peak that ``REMAT_FREE_PEAK`` predicts for the model at the
    per-replica batch (``batch_size`` // ``n_devices``, as gan_tpu's
    ``per_dev``) × (``img_size`` / 256)² image equivalents exceeds the
    share of ``device_memory`` that the device-cache plan leaves to training
    (1 − ``DEVICE_CACHE_FRACTION``). On the H100 80GB (79.18 GiB) that is
    past 996 equivalents for Pix2Pix (512², batch 250), beyond the largest
    batch measured, so the line is extrapolated there, and past 260 for
    CycleGAN (512², batch 66), between the measured batches 64 (46.56 GiB
    remat-free) and 72 (52.12 GiB). Phase 14f measured remat slower at every
    point (8-15% a graph step) while it cut the peak by 7-34%, so ``auto``
    does not copy gan_tpu's v5e rule, which also turned remat on at 512²
    batches of 8 or less, where the v5e ran faster with it."""
    if config.remat in ("on", "off"):
        return config.remat == "on"
    fixed, per_image = REMAT_FREE_PEAK["cyclegan" if isinstance(config, CycleGANConfig)
                                       else "pix2pix"]
    images = config.batch_size // max(1, n_devices) * (config.img_size / 256) ** 2
    return fixed + per_image * images > (1 - DEVICE_CACHE_FRACTION) * device_memory


class Pix2PixTrainer(GANTrainer):
    def __init__(self, config: Pix2PixConfig, replicas: Optional[Replicas] = None):
        replicas = single() if replicas is None else replicas
        c = config.n_channels
        init = torch.Generator().manual_seed(config.seed)   # CPU draws: same weights on any device
        self.gen = UNetGenerator(c, c, norm="batch", depth=generator_depth(config.img_size),
                                 generator=init,
                                 remat=use_remat(config, device_bytes(replicas.device),
                                                 replicas.size))
        self.disc = PatchGANDiscriminator(c, norm="batch", target=True, generator=init)
        super().__init__(config, {name: getattr(self, name) for name in NETWORKS},
                         GRADIENT_GROUPS, sampler="gen", replicas=replicas)
        # the full steps' cross-replica batch norm: only over W > 1 replicas
        # (gan_tpu's pix2pix_trainer.py:133-134)
        self.bn_group = (replicas.group if config.bn_cross_replica == "true"
                         and replicas.size > 1 else None)

    # ------------------------------------------------------------------ step
    def _losses(self, x, y, generator: Optional[torch.Generator], masks=None, bn_group=None):
        """((the generator's total, the discriminator's), the 4 losses in
        PIX2PIX_LOSS_KEYS order). ``generator`` draws the dropout, or
        ``masks`` ([G's keep-masks]) gives it; with neither it is off.
        ``bn_group``: cross-replica batch-norm statistics."""
        cfg = self.config
        dt = self.dtype
        fake = self.gen(x, generator=generator, masks=None if masks is None else masks[0],
                        compute_dtype=dt, bn_group=bn_group)
        d_real = self.disc(x, y, compute_dtype=dt, bn_group=bn_group)
        d_fake = self.disc(x, fake, compute_dtype=dt, bn_group=bn_group)
        gen_total, gen_gan, gen_sec = pix2pix_generator_loss(
            d_fake, fake, y, lam=float(cfg.lam), kind=cfg.generator_loss)
        disc = discriminator_loss(d_real, d_fake, 0.5)
        return (gen_total, disc), torch.stack([gen_total, gen_gan, gen_sec, disc])

    def _step(self, u8: torch.Tensor, epoch: int, stream: int, step: int) -> torch.Tensor:
        """Draws, paired jitter (train) or normalize (val), then a train or
        eval step. u8: (B, 2, S', S', C) uint8 rows on the device."""
        seed = self.config.seed + 1
        drop = self._draws(seed, epoch, stream, step, _DROPOUT)
        if stream == 0:
            x, y = paired_jitter_batch(u8, self._draws(seed, epoch, stream, step, _JITTER),
                                       img_size=self.config.img_size, dtype=self.dtype)
            return self.train_step(x, y, drop)
        x, y = (normalize_batch(u8[:, k], self.dtype).contiguous() for k in (0, 1))
        return self.eval_step(x, y, drop)

    def _step_draws(self, epoch: int, stream: int, step: int) -> StepDraws:
        seed, b, size = self.config.seed + 1, self.local_batch, self.config.img_size
        key = (seed, epoch, stream, step, *self._rank_key)
        masks = [self._masks(self.gen, self._draws(*key, _DROPOUT), b)]
        if stream != 0:
            return StepDraws(masks, [])
        jitter = jitter_draws(b, size + JITTER_PAD, size, self._draws(*key, _JITTER), self.device)
        return StepDraws(masks, [jitter])

    def _epoch_step(self, caches, idx, draws: StepDraws, training: bool) -> torch.Tensor:
        u8 = caches[0].index_select(0, idx[0])
        if training:
            x, y = paired_jitter_batch(u8, None, img_size=self.config.img_size, dtype=self.dtype,
                                       draws=draws.jitter[0])
            return self.train_step(x, y, masks=draws.masks, bn_group=self.bn_group)
        x, y = (normalize_batch(u8[:, k], self.dtype).contiguous() for k in (0, 1))
        return self.eval_step(x, y, masks=draws.masks, bn_group=self.bn_group)

    def run_epoch(self, cache, epoch: int, *, training: bool) -> np.ndarray:
        """One pass over a uint8 cache in its fixed order: the full batches
        through the cached epoch runner, then the remainder as an eager
        step. ``cache`` is a tensor on the device or, over W > 1 replicas,
        a :class:`~gan_tpu_torch.train.base.Stripe` (resident), or a host
        ndarray or FileCache (streamed). Returns (steps, 4) losses, fetched
        from the device once; over replicas, their means."""
        with span("gan_tpu_torch.epoch"):
            w, r, b = self.replicas.size, self.replicas.rank, self.local_batch
            n = cache.shape[0]
            resident = isinstance(cache, (torch.Tensor, Stripe))
            with span("gan_tpu_torch.epoch.plan"):
                full, tail = loop.epoch_plan(n, self.config.batch_size, w)
                # the rows of this replica's stripe that each full step takes
                local = loop.local_perm(n, ndev=w, n_steps=full,
                                        per_dev_batch=b)[:, r * b:(r + 1) * b]
                if resident and full:
                    rows = torch.from_numpy(local.astype(np.int64)).to(self.device)
            if resident:
                losses = []
                if full:
                    losses.append(self._cached_epoch(
                        (cache.local if isinstance(cache, Stripe) else cache,), (rows,), epoch,
                        training))
                if tail:
                    with span("gan_tpu_torch.step.eager"):
                        losses.append(self._step(self._tail_rows(cache, np.arange(n - tail, n)),
                                                 epoch, 0 if training else 1, full)[None])
            else:
                batches = self._rank_batches(cache, local.reshape(-1).astype(np.int64) * w + r,
                                             np.arange(n - tail, n))
                losses = self._streamed_epoch((cache,), ((u8,) for u8 in batches), full, tail,
                                              epoch, training)
            if not losses:
                return np.zeros((0, len(PIX2PIX_LOSS_KEYS)), np.float32)
            with span("gan_tpu_torch.epoch.fetch"):
                return torch.cat(losses).cpu().numpy()

    # ------------------------------------------------------------------- fit
    def fit(self, train_cache, val_cache, test_cache: np.ndarray,
            output_path: str, checkpoint_manager: Optional[CheckpointManager] = None,
            start_epoch: int = 0):
        """Epoch loop of the reference (pix2pix.py:248-323), from
        ``start_epoch`` (a resumed run). Caches from
        gan_tpu_torch.data.pipeline.build_pix2pix_cache: train
        (N, 2, S+30, S+30, C), val and test (N, 2, S, S, C); train and val
        may be FileCaches of such rows instead, and stream. A checkpoint and
        an ``epoch_{N}.png`` sample every 5 epochs, a checkpoint at the end,
        and one every ``--checkpoint-every`` epochs (over replicas, rank 0
        writes the samples, and only the ranks given a manager save).
        Returns the per-epoch mean losses of train and val, of the epochs
        this call trained."""
        cfg = self.config
        print("\nTraining...\n", flush=True)
        example = test_cache[:1].astype(np.float32) / 127.5 - 1.0
        (train_src,), (val_src,) = self._plan_caches([(train_cache,), (val_cache,)])
        start = time.time()
        train_cost = empty_losses(PIX2PIX_LOSS_KEYS)
        val_cost = empty_losses(PIX2PIX_LOSS_KEYS)
        writes = self.replicas.rank == 0   # only rank 0 writes samples

        def epoch_body(epoch: int) -> None:
            tr = self._timed_epoch(lambda: self.run_epoch(train_src, epoch, training=True),
                                   epoch, start_epoch, lambda _: train_cache.shape[0], "images")
            print("." * (tr.shape[0] // 100), end="", flush=True)
            va = self.run_epoch(val_src, epoch, training=False)
            for i, k in enumerate(PIX2PIX_LOSS_KEYS):
                train_cost[k].append(float(tr[:, i].mean()) if len(tr) else float("nan"))
                val_cost[k].append(float(va[:, i].mean()) if len(va) else float("nan"))

            test_img_path = os.path.join(output_path, "test_images")
            if writes:
                os.makedirs(test_img_path, exist_ok=True)
            if (epoch + 1) % 5 == 0 and (epoch + 1) != cfg.epochs:
                if checkpoint_manager is not None:
                    checkpoint_manager.save(epoch + 1, self.state())
                if writes:
                    self.generate_image(example[:, 0], example[:, 1],
                                        os.path.join(test_img_path, f"epoch_{epoch + 1}.png"),
                                        key_index=epoch + 1)
            if (epoch + 1) == cfg.epochs and checkpoint_manager is not None:
                checkpoint_manager.save(epoch + 1, self.state())
            self._checkpoint_every(epoch + 1, checkpoint_manager)

            print(f"\nCumulative training duration at end of epoch {epoch + 1}: "
                  f"{(time.time() - start) / 60:.2f} min")
            print(f"Train generator loss: {round(train_cost['Generator Total Loss'][-1], 2)}, "
                  f"train discriminator loss: {round(train_cost['Discriminator Loss'][-1], 2)}")
            print(f"Val generator loss: {round(val_cost['Generator Total Loss'][-1], 2)}, "
                  f"val discriminator loss: {round(val_cost['Discriminator Loss'][-1], 2)}\n")

        self._fenced_epochs(epoch_body, checkpoint_manager, start_epoch, (train_cost, val_cost))
        return train_cost, val_cost

    # --------------------------------------------------------------- predict
    def generate_image(self, input_image: np.ndarray, target: np.ndarray, path_filename: str,
                       key_index: Optional[int] = None) -> None:
        """3-panel Input / Ground Truth / Predicted grid."""
        pred = self.generate(input_image, key_index=key_index)
        save_image_grid([input_image[0], target[0], pred[0]], path_filename,
                        channels=self.config.channels)

    def predict(self, predict_cache, output_path: str,
                raw: bool = False, raw_names=None) -> None:
        """prediction_images/img{N}.png (Input / Ground Truth / Predicted) for
        each (N, 2, S, S, C) pair of an ndarray or a FileCache, in 64-image
        chunks (train/base.py ``_predict``)."""
        self._predict(predict_cache, output_path, raw, raw_names,
                      inputs=lambda batch: batch[:, 0],
                      panels=lambda pair, pred: [pair[0], pair[1], pred])
