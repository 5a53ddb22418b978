"""CycleGAN trainer (counterpart of gan_tpu/train/cyclegan_trainer.py).

It holds the reference's four networks: the instance-norm U-Net generators
g: X→Y and f: Y→X, the PatchGAN discriminators of each domain, and one Adam
per network.

**The step** (gan_tpu_torch/train/base.py). gan_tpu takes one gradient of
one combined scalar, each term with every other network's parameters
stop-gradiented (``sg_tree``), and lets XLA merge the duplicated forwards.
Here each forward runs once, and the networks fall into two gradient
groups, one ``torch.autograd.grad`` each (``GRADIENT_GROUPS``):

- the generators: adv_g + adv_f + total_cycle + id_g + id_f with respect
  to both generators' parameters;
- the discriminators: disc_x + disc_y with respect to both discriminators'.

This equals the reference's one tape per network (cycle_gan.py:244-262).
adv_f and id_f do not depend on G, and adv_g and id_g do not depend on F;
total_cycle appears once in the sum, and each generator's own total holds it
once; so each generator takes the gradient of its own total. The two
discriminators' parameters are disjoint. The adversarial loss reaches a
generator through a discriminator whose parameters the generators' walk
does not collect, and the discriminators' walk stops at their inputs, as if
the fakes were detached; so one D(fake) serves both the adversarial and the
discriminator loss.

**The forward** takes gan_tpu's two structures, switched on the wider
domain's batch as gan_tpu switches them. Where it is at most
``BATCHED_PASS_MAX`` rows, the six generator applications run as three
batched U-Net passes, G(cat[x, y]), F(cat[fake_y, y, x]) and G(fake_x)
(``BATCHED_PASSES``), and each discriminator's real and fake batches as one
pass, D_x(cat[x, fake_x]) and D_y(cat[y, fake_y]). Above it they run as ten
forwards (``UNBATCHED_PASSES``, then D on each real and each fake batch).
Both are exact because every norm is instance norm, per sample, and each
dropout mask is drawn per sample; a pass's output is split by its inputs'
widths, which differ at the zip tail. gan_tpu switches at 16 rows, its v5e
crossover. The H100's crossover lies at a number of pixels
(``batched_pass_max``): the batched form's graph step was the faster up to
4 256²-images per domain (256² batch 1, 2 and 4; 512² batch 1) and the
slower from 8 on (256² batch 8, 16 and 32; 512² batch 2 and 4), where its
concatenated passes take the 1-channel stems' input gradient over rows that
need none (chip_smoke.py ``form_sweep``; PERF.md).

**Draws.** Dropout masks and jitter offsets come from ``torch.Generator``s
seeded as a pure function of (seed + 1, epoch, train or val, step, index),
so a re-run repeats its draws, as ``loop.epoch_rng`` does for the shuffles;
over W > 1 replicas a full step's key holds the rank before the index.
The index of a dropout generator is its generator pass's, one per pass as
gan_tpu draws one key per pass (three in the batched form, six in the
unbatched one); the jitter's indices lie past every pass's.

**Epochs.** Both domains' uint8 train and val caches live whole on the
device when they fit, or stream from the host (``--device-cache off``, or
FileCaches under ``--host-cache off``) with the same shuffles and draws;
one step per zipped batch. The full steps run through the cached epoch
runner (a CUDA graph of the step on the card, gan_tpu's compiled epoch;
train/base.py), the zip tail, whose X and Y widths may differ, as an eager
step (gan_tpu's ``_run_remainder``). ``fit`` resumes at ``start_epoch``
(``--resume``), saves every ``--checkpoint-every`` epochs and runs every
epoch inside gan_tpu's fault fence (train/recovery.py): a fault rewinds to
the last checkpoint in-process, and the per-epoch shuffles and draws, pure
in (seed, epoch, step), are drawn again exactly. gan_tpu's hybrid tier and
epoch segments are not ported.

**Data parallelism** (train/base.py): over W replicas each domain's epoch
order is drawn per stripe (``loop.shuffled_stripe_perm``, ``--buffer-size``
per stripe), each replica taking B / W rows of its own stripe per full step,
and the zip tail is drawn from the rows that the full steps left, so that
an epoch visits every row at most once at any W; it runs whole on every
replica. ``passes`` decides the form from the rows a step sees, so a full
step's form follows the per-replica batch.
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
from gan_tpu_torch.data.loader import device_bytes, zip_closing
from gan_tpu_torch.losses import (CYCLEGAN_LOSS_KEYS, cycle_loss, discriminator_loss,
                                  empty_losses, generator_adversarial_loss, identity_loss)
from gan_tpu_torch.models import PatchGANDiscriminator, UNetGenerator
from gan_tpu_torch.parallel import Replicas, single
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.base import GANTrainer, StepDraws, Stripe, generator_depth
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.pix2pix_trainer import use_remat
from gan_tpu_torch.utils.grids import save_image_grid
from gan_tpu_torch.utils.profiling import span

NETWORKS = ("gen_g", "gen_f", "disc_x", "disc_y")
GRADIENT_GROUPS = (("gen_g", "gen_f"), ("disc_x", "disc_y"))
# gan_tpu's two structures of the six generator applications, as passes in
# call order: (generator, the batches it takes concatenated, its outputs)
BATCHED_PASSES = (("gen_g", ("x", "y"), ("fake_y", "same_y")),
                  ("gen_f", ("fake_y", "y", "x"), ("cycled_x", "fake_x", "same_x")),
                  ("gen_g", ("fake_x",), ("cycled_y",)))
UNBATCHED_PASSES = (("gen_g", ("x",), ("fake_y",)), ("gen_f", ("fake_y",), ("cycled_x",)),
                    ("gen_f", ("y",), ("fake_x",)), ("gen_g", ("fake_x",), ("cycled_y",)),
                    ("gen_f", ("x",), ("same_x",)), ("gen_g", ("y",), ("same_y",)))
_DOMAIN = {"x": "x", "fake_y": "x", "y": "y", "fake_x": "y"}   # whose rows a pass input has
_JITTER_X, _JITTER_Y = len(UNBATCHED_PASSES), len(UNBATCHED_PASSES) + 1   # past every pass's
# the most 256²-image equivalents per domain at which the batched form's
# step was the faster on the H100 (the module docstring)
BATCHED_EQUIVALENTS_MAX = 4


def batched_pass_max(img_size: int) -> int:
    """The most rows per domain at which a step at ``img_size`` runs the
    batched form on the card: 4 at 256², 1 at 512²."""
    return int(BATCHED_EQUIVALENTS_MAX * (256 / img_size) ** 2)


def pass_widths(passes: tuple, bx: int, by: int) -> list[int]:
    """The batch of each pass of ``passes`` in a step of bx X and by Y rows."""
    rows = {"x": bx, "y": by}
    return [sum(rows[_DOMAIN[i]] for i in inputs) for _net, inputs, _outputs in passes]


class CycleGANTrainer(GANTrainer):
    # rows; None: the card's crossover at the image size (``batched_pass_max``)
    BATCHED_PASS_MAX: Optional[int] = None

    def __init__(self, config: CycleGANConfig, replicas: Optional[Replicas] = None):
        replicas = single() if replicas is None else replicas
        c = config.n_channels
        init = torch.Generator().manual_seed(config.seed)   # CPU draws: same weights on any device
        depth = generator_depth(config.img_size)
        remat = use_remat(config, device_bytes(replicas.device), replicas.size)
        self.gen_g = UNetGenerator(c, c, norm="instance", depth=depth, generator=init, remat=remat)
        self.gen_f = UNetGenerator(c, c, norm="instance", depth=depth, generator=init, remat=remat)
        self.disc_x = PatchGANDiscriminator(c, norm="instance", generator=init)
        self.disc_y = PatchGANDiscriminator(c, norm="instance", generator=init)
        super().__init__(config, {name: getattr(self, name) for name in NETWORKS},
                         GRADIENT_GROUPS, sampler="gen_g", replicas=replicas)

    # ------------------------------------------------------------------ step
    def passes(self, bx: int, by: int) -> tuple:
        """The generator passes of a step of bx X and by Y rows: gan_tpu's
        batched form up to ``BATCHED_PASS_MAX`` rows in the wider domain,
        else the unbatched one."""
        limit = self.BATCHED_PASS_MAX
        if limit is None:
            limit = batched_pass_max(self.config.img_size)
        return BATCHED_PASSES if max(bx, by) <= limit else UNBATCHED_PASSES

    def _losses(self, x, y, generators: Optional[Sequence[torch.Generator]], masks=None,
                bn_group=None):
        """((the generators' objective, the discriminators'), the 7 losses in
        CYCLEGAN_LOSS_KEYS order). ``generators``: one dropout generator per
        generator pass of ``passes``, in its order, or ``masks``: each
        pass's keep-masks; with neither dropout is off. ``bn_group`` changes
        nothing: every norm here is instance norm."""
        dt = self.dtype
        lam = float(self.config.lam)
        passes = self.passes(x.shape[0], y.shape[0])
        k = list(generators) if generators is not None else [None] * len(passes)
        m = list(masks) if masks is not None else [None] * len(passes)
        img = {"x": x, "y": y}
        for i, (net, inputs, outputs) in enumerate(passes):
            parts = [img[name] for name in inputs]
            out = self.nets[net](torch.cat(parts) if len(parts) > 1 else parts[0],
                                 generator=k[i], masks=m[i], compute_dtype=dt)
            img.update(zip(outputs, out.split([p.shape[0] for p in parts])
                           if len(parts) > 1 else (out,)))

        def disc(net, real, fake):
            if passes is BATCHED_PASSES:   # real and fake as one pass
                out = net(torch.cat([real, fake]), compute_dtype=dt)
                return out.split([real.shape[0], fake.shape[0]])
            return net(real, compute_dtype=dt), net(fake, compute_dtype=dt)

        dx_real, dx_fake = disc(self.disc_x, x, img["fake_x"])
        dy_real, dy_fake = disc(self.disc_y, y, img["fake_y"])
        adv_g = generator_adversarial_loss(dy_fake)
        adv_f = generator_adversarial_loss(dx_fake)
        total_cycle = cycle_loss(x, img["cycled_x"], lam) + cycle_loss(y, img["cycled_y"], lam)
        id_g = identity_loss(y, img["same_y"], lam)
        id_f = identity_loss(x, img["same_x"], lam)
        disc_x = discriminator_loss(dx_real, dx_fake, 0.5)
        disc_y = discriminator_loss(dy_real, dy_fake, 0.5)
        losses = torch.stack([adv_g, adv_f, total_cycle, adv_g + total_cycle + id_g,
                              adv_f + total_cycle + id_f, disc_x, disc_y])
        return (adv_g + adv_f + total_cycle + id_g + id_f, disc_x + disc_y), losses

    def _step(self, u8x, u8y, epoch: int, stream: int, step: int) -> torch.Tensor:
        """Draws, jitter (train) or normalize (val), then a train or eval step."""
        seed = self.config.seed + 1
        gens = [self._draws(seed, epoch, stream, step, k)
                for k in range(len(self.passes(u8x.shape[0], u8y.shape[0])))]
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
        seed, b, size = self.config.seed + 1, self.local_batch, self.config.img_size
        key = (seed, epoch, stream, step, *self._rank_key)
        passes = self.passes(b, b)
        masks = [self._masks(self.nets[net], self._draws(*key, k), width)
                 for k, ((net, _, _), width) in enumerate(zip(passes, pass_widths(passes, b, b)))]
        if stream != 0:
            return StepDraws(masks, [])
        jitter = [jitter_draws(b, size + JITTER_PAD, size, self._draws(*key, index), self.device)
                  for index in (_JITTER_X, _JITTER_Y)]
        return StepDraws(masks, jitter)

    def _epoch_step(self, caches, idx, draws: StepDraws, training: bool) -> torch.Tensor:
        u8x, u8y = (cache.index_select(0, i) for cache, i in zip(caches, idx))
        if training:
            x, y = (single_jitter_batch(u8, None, img_size=self.config.img_size, dtype=self.dtype,
                                        draws=jitter) for u8, jitter in zip((u8x, u8y), draws.jitter))
            return self.train_step(x, y, masks=draws.masks)
        return self.eval_step(normalize_batch(u8x, self.dtype), normalize_batch(u8y, self.dtype),
                              masks=draws.masks)

    def _orders(self, ns: tuple, full: int, tail: int, rng: np.random.Generator) -> list:
        """Per domain of ``ns`` rows, this replica's full steps' rows, (full,
        local_batch) indices into its cache (its stripe over W > 1
        replicas), and the zip tail's global rows (where there is a
        ``tail``: up to B, as many as the domain has left; the longer
        domain's rows past the zip are never read). One replica draws each
        domain's whole order (``epoch_perm``); over W > 1,
        ``shuffled_stripe_perm`` draws each stripe's, and the tail comes
        from the rows it left."""
        cfg, w, r, b = self.config, self.replicas.size, self.replicas.rank, self.local_batch
        big = cfg.batch_size
        out = []
        for n in ns:
            if w == 1:
                perm = loop.epoch_perm(n, cfg.buffer_size, rng)
                local, left = perm[:full * b].reshape(full, b), perm[full * b:]
            else:
                perm, left = loop.shuffled_stripe_perm(n, ndev=w, n_steps=full, per_dev_batch=b,
                                                       buffer_size=cfg.buffer_size, rng=rng)
                local = perm[:, r * b:(r + 1) * b].astype(np.int64)
            out.append((local, left[:min(big, n - full * big) if tail else 0]))
        return out

    def run_epoch(self, x, y, epoch: int, *, training: bool) -> np.ndarray:
        """One zip(X, Y) pass over uint8 caches: the shorter domain's
        ceil-batched length, independent windowed shuffles per domain
        (``--buffer-size``). The caches are tensors on the device or, over
        W > 1 replicas, :class:`~gan_tpu_torch.train.base.Stripe` caches
        (resident), or host ndarrays or FileCaches (streamed, in the same
        orders). The full steps run through the cached epoch runner; the
        last step may be the zip tail, a partial batch whose X and Y widths
        may differ, run eagerly. Returns (steps, 7) losses, fetched from the
        device once; over replicas, their means."""
        with span("gan_tpu_torch.epoch"):
            cfg = self.config
            w, r = self.replicas.size, self.replicas.rank
            nx, ny = x.shape[0], y.shape[0]
            resident = isinstance(x, (torch.Tensor, Stripe))
            with span("gan_tpu_torch.epoch.plan"):
                full, tail = loop.epoch_plan(min(nx, ny), cfg.batch_size, w)
                if full + (tail > 0) == 0:
                    return np.zeros((0, len(CYCLEGAN_LOSS_KEYS)), np.float32)
                stream = 0 if training else 1
                orders = self._orders((nx, ny), full, tail,
                                      loop.epoch_rng(cfg.seed, epoch, stream))
                if resident and full:
                    rows = tuple(torch.from_numpy(local).to(self.device) for local, _ in orders)
            if not resident:
                batches = zip_closing([self._rank_batches(c, local.reshape(-1) * w + r, left)
                                       for c, (local, left) in zip((x, y), orders)])
                losses = self._streamed_epoch((x, y), batches, full, tail, epoch, training)
            else:
                caches = (x, y)
                losses = []
                if full:
                    losses.append(self._cached_epoch(
                        tuple(c.local if isinstance(c, Stripe) else c for c in caches), rows,
                        epoch, training))
                if tail:
                    with span("gan_tpu_torch.step.eager"):
                        losses.append(self._step(*(self._tail_rows(c, left)
                                                   for c, (_, left) in zip(caches, orders)),
                                                 epoch, stream, full)[None])
            with span("gan_tpu_torch.epoch.fetch"):
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
        checkpoint at the end, and one every ``--checkpoint-every`` epochs
        (over replicas, rank 0 writes the samples, and only the ranks given
        a manager save). Returns the per-epoch mean losses of train and val,
        of the epochs this call trained."""
        cfg = self.config
        print("\nTraining...\n", flush=True)
        example = test_cache[:1].astype(np.float32) / 127.5 - 1.0
        train_src, val_src = self._plan_caches([(train_x, train_y), (val_x, val_y)])
        start = time.time()
        train_cost = empty_losses(CYCLEGAN_LOSS_KEYS)
        val_cost = empty_losses(CYCLEGAN_LOSS_KEYS)
        writes = self.replicas.rank == 0   # only rank 0 writes samples
        # pairs consumed: the zip tail is partial, so it is not counted full
        pairs = lambda tr: min(tr.shape[0] * cfg.batch_size, len(train_x), len(train_y))

        def epoch_body(epoch: int) -> None:
            tr = self._timed_epoch(
                lambda: self.run_epoch(*train_src, epoch, training=True),
                epoch, start_epoch, pairs, "image-pairs")
            print("." * (tr.shape[0] // 100), end="", flush=True)
            va = self.run_epoch(*val_src, epoch, training=False)
            for i, k in enumerate(CYCLEGAN_LOSS_KEYS):
                train_cost[k].append(float(tr[:, i].mean()) if len(tr) else float("nan"))
                val_cost[k].append(float(va[:, i].mean()) if len(va) else float("nan"))

            test_img_path = os.path.join(output_path, "test_images")
            if writes:
                os.makedirs(test_img_path, exist_ok=True)
            if (epoch + 1) % 5 == 0 and (epoch + 1) != cfg.epochs:
                if checkpoint_manager is not None:
                    checkpoint_manager.save(epoch + 1, self.state())
                if writes:
                    self.generate_image(example, os.path.join(test_img_path,
                                                              f"epoch_{epoch + 1}.png"),
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

        self._fenced_epochs(epoch_body, checkpoint_manager, start_epoch, (train_cost, val_cost))
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
