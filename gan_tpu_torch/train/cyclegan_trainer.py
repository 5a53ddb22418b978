"""CycleGAN trainer (counterpart of gan_tpu/train/cyclegan_trainer.py).

It holds the reference's four networks: the instance-norm U-Net generators
g: X→Y and f: Y→X, the PatchGAN discriminators of each domain, and one Adam
per network.

**The step** (gan_tpu_torch/train/base.py). gan_tpu makes one fused
backward over a combined scalar with every other network's parameters
stop-gradiented, and lets XLA merge the duplicated forwards. Eager PyTorch
merges nothing, so here each forward runs once: six generator applications
(fake_y = G(x), cycled_x = F(fake_y), fake_x = F(y), cycled_y = G(fake_x),
same_x = F(x), same_y = G(y)) and four discriminator ones (D_y on y and
fake_y, D_x on x and fake_x). Each network takes its own gradient of its own
total, which gives the reference's four tapes: the cycle loss sits in both
generator totals; the adversarial loss reaches a generator through a
discriminator whose parameters take no gradient from it; and a
discriminator's gradient stops at the fake, as if it were detached. So one
D(fake) serves both the adversarial and the discriminator loss.

**Draws.** Dropout masks and jitter offsets come from ``torch.Generator``s
seeded as a pure function of (seed + 1, epoch, train or val, step,
application), so a re-run repeats its draws, as ``loop.epoch_rng`` does for
the shuffles.

**Epochs.** Both domains' uint8 train and val caches live whole on the
device when they fit, or stream from the host (``--device-cache off``, or
FileCaches under ``--host-cache off``) with the same shuffles and draws;
one step per zipped batch. The full steps run through the cached epoch
runner (a CUDA graph of the step on the card, gan_tpu's compiled epoch;
train/base.py), the zip tail, whose X and Y widths may differ, as an eager
step (gan_tpu's ``_run_remainder``). ``fit`` resumes at ``start_epoch``
(``--resume``) and saves every ``--checkpoint-every`` epochs. gan_tpu's
hybrid tier, epoch segments and the fault fence's in-process rewind are not
ported: a CUDA fault poisons the process's context, so recovery on the card
is a new process with ``--resume``.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gan_tpu_torch.config import CycleGANConfig
from gan_tpu_torch.data.augment import (JITTER_PAD, jitter_draws, normalize_batch,
                                        single_jitter_batch)
from gan_tpu_torch.data.loader import device_bytes, iter_uint8_batches
from gan_tpu_torch.device import default_device
from gan_tpu_torch.losses import (CYCLEGAN_LOSS_KEYS, cycle_loss, discriminator_loss,
                                  empty_losses, generator_adversarial_loss, identity_loss)
from gan_tpu_torch.models import PatchGANDiscriminator, UNetGenerator
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.base import GANTrainer, StepDraws, generator_depth
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.pix2pix_trainer import use_remat
from gan_tpu_torch.utils.grids import save_image_grid
from gan_tpu_torch.utils.profiling import Throughput

NETWORKS = ("gen_g", "gen_f", "disc_x", "disc_y")
GENERATOR_APPLICATIONS = 6   # generator forwards per step, one dropout generator each
# the generator each application runs, in the order of _losses
APPLICATION_NETS = ("gen_g", "gen_f", "gen_f", "gen_g", "gen_f", "gen_g")
_JITTER_X, _JITTER_Y = GENERATOR_APPLICATIONS, GENERATOR_APPLICATIONS + 1   # draw indices


class CycleGANTrainer(GANTrainer):
    def __init__(self, config: CycleGANConfig):
        c = config.n_channels
        init = torch.Generator().manual_seed(config.seed)   # CPU draws: same weights on any device
        depth = generator_depth(config.img_size)
        remat = use_remat(config, device_bytes(default_device()))
        self.gen_g = UNetGenerator(c, c, norm="instance", depth=depth, generator=init, remat=remat)
        self.gen_f = UNetGenerator(c, c, norm="instance", depth=depth, generator=init, remat=remat)
        self.disc_x = PatchGANDiscriminator(c, norm="instance", generator=init)
        self.disc_y = PatchGANDiscriminator(c, norm="instance", generator=init)
        super().__init__(config, {name: getattr(self, name) for name in NETWORKS},
                         sampler="gen_g")

    # ------------------------------------------------------------------ step
    def _losses(self, x, y, generators: Optional[Sequence[torch.Generator]], masks=None):
        """({network: its total loss}, the 7 losses in CYCLEGAN_LOSS_KEYS order).
        ``generators``: one dropout generator per generator application, in
        the order below (APPLICATION_NETS), or ``masks``: each application's
        keep-masks; with neither dropout is off."""
        dt = self.dtype
        lam = float(self.config.lam)
        k = list(generators) if generators is not None else [None] * GENERATOR_APPLICATIONS
        m = list(masks) if masks is not None else [None] * GENERATOR_APPLICATIONS

        def gen(net, img, app):
            return net(img, generator=k[app], masks=m[app], compute_dtype=dt)

        fake_y = gen(self.gen_g, x, 0)
        cycled_x = gen(self.gen_f, fake_y, 1)
        fake_x = gen(self.gen_f, y, 2)
        cycled_y = gen(self.gen_g, fake_x, 3)
        same_x = gen(self.gen_f, x, 4)
        same_y = gen(self.gen_g, y, 5)
        dx_real = self.disc_x(x, compute_dtype=dt)
        dx_fake = self.disc_x(fake_x, compute_dtype=dt)
        dy_real = self.disc_y(y, compute_dtype=dt)
        dy_fake = self.disc_y(fake_y, compute_dtype=dt)

        adv_g = generator_adversarial_loss(dy_fake)
        adv_f = generator_adversarial_loss(dx_fake)
        total_cycle = cycle_loss(x, cycled_x, lam) + cycle_loss(y, cycled_y, lam)
        total_g = adv_g + total_cycle + identity_loss(y, same_y, lam)
        total_f = adv_f + total_cycle + identity_loss(x, same_x, lam)
        disc_x = discriminator_loss(dx_real, dx_fake, 0.5)
        disc_y = discriminator_loss(dy_real, dy_fake, 0.5)
        totals = {"gen_g": total_g, "gen_f": total_f, "disc_x": disc_x, "disc_y": disc_y}
        losses = torch.stack([adv_g, adv_f, total_cycle, total_g, total_f, disc_x, disc_y])
        return totals, losses

    def _step(self, u8x, u8y, epoch: int, stream: int, step: int) -> torch.Tensor:
        """Draws, jitter (train) or normalize (val), then a train or eval step."""
        seed = self.config.seed + 1
        gens = [self._draws(seed, epoch, stream, step, app)
                for app in range(GENERATOR_APPLICATIONS)]
        if stream == 0:
            size = self.config.img_size
            x = single_jitter_batch(u8x, self._draws(seed, epoch, stream, step, _JITTER_X),
                                    img_size=size, dtype=self.dtype)
            y = single_jitter_batch(u8y, self._draws(seed, epoch, stream, step, _JITTER_Y),
                                    img_size=size, dtype=self.dtype)
            return self.train_step(x, y, gens)
        return self.eval_step(normalize_batch(u8x, self.dtype), normalize_batch(u8y, self.dtype),
                              gens)

    def _step_draws(self, epoch: int, stream: int, step: int) -> StepDraws:
        seed, b, size = self.config.seed + 1, self.config.batch_size, self.config.img_size
        masks = [self._masks(self.nets[net], self._draws(seed, epoch, stream, step, app), b)
                 for app, net in enumerate(APPLICATION_NETS)]
        if stream != 0:
            return StepDraws(masks, [])
        jitter = [jitter_draws(b, size + JITTER_PAD, size,
                               self._draws(seed, epoch, stream, step, key), self.device)
                  for key in (_JITTER_X, _JITTER_Y)]
        return StepDraws(masks, jitter)

    def _epoch_step(self, caches, idx, draws: StepDraws, training: bool) -> torch.Tensor:
        u8x, u8y = (cache.index_select(0, i) for cache, i in zip(caches, idx))
        if training:
            x, y = (single_jitter_batch(u8, None, img_size=self.config.img_size, dtype=self.dtype,
                                        draws=jitter) for u8, jitter in zip((u8x, u8y), draws.jitter))
            return self.train_step(x, y, masks=draws.masks)
        return self.eval_step(normalize_batch(u8x, self.dtype), normalize_batch(u8y, self.dtype),
                              masks=draws.masks)

    def run_epoch(self, x, y, epoch: int, *, training: bool) -> np.ndarray:
        """One zip(X, Y) pass over uint8 caches: the shorter domain's
        ceil-batched length, independent windowed shuffles per domain
        (``--buffer-size``). The caches are tensors on the device
        (resident), or host ndarrays or FileCaches (streamed, in the same
        orders). The full steps run through the cached epoch runner; the
        last step may be the zip tail, a partial batch whose X and Y widths
        may differ, run eagerly. Returns (steps, 7) losses, fetched from the
        device once."""
        cfg = self.config
        b = cfg.batch_size
        nx, ny = x.shape[0], y.shape[0]
        full, tail = loop.epoch_plan(min(nx, ny), b)
        if full + (tail > 0) == 0:
            return np.zeros((0, len(CYCLEGAN_LOSS_KEYS)), np.float32)
        stream = 0 if training else 1
        rng = loop.epoch_rng(cfg.seed, epoch, stream)
        perms = [loop.epoch_perm(n, cfg.buffer_size, rng) for n in (nx, ny)]
        if not isinstance(x, torch.Tensor):
            steps = full + (tail > 0)   # the longer domain's rows past the zip are never read
            batches = zip(*(iter_uint8_batches(c, b, p[:steps * b]) for c, p in zip((x, y), perms)))
            losses = self._streamed_epoch((x, y), batches, full, tail, epoch, training)
            return torch.cat(losses).cpu().numpy()
        x_dev, y_dev = x, y
        perm_x, perm_y = (torch.from_numpy(p).to(self.device) for p in perms)
        losses = []
        if full:
            rows = (perm_x[:full * b].view(full, b), perm_y[:full * b].view(full, b))
            losses.append(self._cached_epoch((x_dev, y_dev), rows, epoch, training))
        if tail:
            s = full
            losses.append(self._step(x_dev[perm_x[s * b:(s + 1) * b]],
                                     y_dev[perm_y[s * b:(s + 1) * b]], epoch, stream, s)[None])
        return torch.cat(losses).cpu().numpy()

    # ------------------------------------------------------------------- fit
    def fit(self, train_x, train_y, val_x, val_y, test_cache: np.ndarray, output_path: str,
            checkpoint_manager: Optional[CheckpointManager] = None, start_epoch: int = 0):
        """Epoch loop of the reference (cycle_gan.py:278-358), from
        ``start_epoch`` (a resumed run). Caches from
        gan_tpu_torch.data.pipeline.build_cyclegan_cache: train
        (N, S+30, S+30, C), val and test (N, S, S, C); the train and val
        caches may be FileCaches of such rows instead, and stream. A
        checkpoint and an ``epoch_{N}.png`` sample every 5 epochs, a
        checkpoint at the end, and one every ``--checkpoint-every`` epochs.
        Returns the per-epoch mean losses of train and val, of the epochs
        this call trained."""
        cfg = self.config
        print("\nTraining...\n", flush=True)
        example = test_cache[:1].astype(np.float32) / 127.5 - 1.0
        train_src, val_src = self._plan_caches([(train_x, train_y), (val_x, val_y)])
        start = time.time()
        train_cost = empty_losses(CYCLEGAN_LOSS_KEYS)
        val_cost = empty_losses(CYCLEGAN_LOSS_KEYS)
        perf = Throughput(1)
        # pairs consumed: the zip tail is partial, so it is not counted full
        pairs = lambda tr: min(tr.shape[0] * cfg.batch_size, len(train_x), len(train_y))
        for epoch in range(start_epoch, cfg.epochs):
            tr = self._timed_epoch(
                lambda: self.run_epoch(*train_src, epoch, training=True),
                epoch, start_epoch, perf, pairs, "image-pairs")
            print("." * (tr.shape[0] // 100), end="", flush=True)
            va = self.run_epoch(*val_src, epoch, training=False)
            for i, k in enumerate(CYCLEGAN_LOSS_KEYS):
                train_cost[k].append(float(tr[:, i].mean()) if len(tr) else float("nan"))
                val_cost[k].append(float(va[:, i].mean()) if len(va) else float("nan"))

            test_img_path = os.path.join(output_path, "test_images")
            os.makedirs(test_img_path, exist_ok=True)
            if (epoch + 1) % 5 == 0 and (epoch + 1) != cfg.epochs:
                if checkpoint_manager is not None:
                    checkpoint_manager.save(epoch + 1, self.state())
                self.generate_image(example, os.path.join(test_img_path, f"epoch_{epoch + 1}.png"),
                                    key_index=epoch + 1)
            if (epoch + 1) == cfg.epochs and checkpoint_manager is not None:
                checkpoint_manager.save(epoch + 1, self.state())
            self._checkpoint_every(epoch + 1, checkpoint_manager)

            print(f"\nCumulative training duration at end of epoch {epoch + 1}: "
                  f"{(time.time() - start) / 60:.2f} min")
            print(f"Train X->Y generator loss: {round(train_cost['Total X->Y Generator Loss'][-1], 2)}, "
                  f"train discriminator X loss: {round(train_cost['Discriminator X Loss'][-1], 2)}")
            print(f"Train Y->X generator loss: {round(train_cost['Total Y->X Generator Loss'][-1], 2)}, "
                  f"train discriminator Y loss: {round(train_cost['Discriminator Y Loss'][-1], 2)}")
            print(f"Val X->Y generator loss: {round(val_cost['Total X->Y Generator Loss'][-1], 2)}, "
                  f"val discriminator X loss: {round(val_cost['Discriminator X Loss'][-1], 2)}")
            print(f"Val Y->X generator loss: {round(val_cost['Total Y->X Generator Loss'][-1], 2)}, "
                  f"val discriminator Y loss: {round(val_cost['Discriminator Y Loss'][-1], 2)}\n")
        return train_cost, val_cost

    # --------------------------------------------------------------- predict
    def generate_image(self, input_image: np.ndarray, path_filename: str,
                       key_index: Optional[int] = None) -> None:
        """2-panel Input / Predicted grid."""
        pred = self.generate(input_image, key_index=key_index)
        save_image_grid([input_image[0], pred[0]], path_filename,
                        channels=self.config.channels)

    def predict(self, predict_cache, output_path: str,
                raw: bool = False, raw_names=None) -> None:
        """prediction_images/img{N}.png via generator_g for each image of an
        ndarray or a FileCache, in 64-image chunks (train/base.py
        ``_predict``)."""
        self._predict(predict_cache, output_path, raw, raw_names,
                      inputs=lambda batch: batch, panels=lambda x, pred: [x, pred])
