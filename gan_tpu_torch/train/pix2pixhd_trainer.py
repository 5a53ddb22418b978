"""pix2pixHD trainer (NVIDIA/pix2pixHD models/pix2pixHD_model.py and
train.py, ``--netG global``): the residual generator, ``num_D``
n-layer discriminators at successive scales and a frozen VGG19 trunk, with
one Adam per trained network (torch's epsilon, 1e-8).

**The step** (train/base.py). The rows (B, H, W, 6) uint8 give the
generator's input, the label one-hot and the instance edges, and the image
(``data.labels.hd_inputs``, after the step's flip draw). fake = G(input);
then, at each scale, D on (input, fake) detached, on (input, image) and on
(input, fake), as pix2pixHD runs them:

* D's objective: ½ (LSGAN(D(fake), 0) + LSGAN(D(image), 1));
* G's objective: LSGAN(D(fake), 1), the feature matching of D(fake)'s
  intermediate features to D(image)'s, and the VGG term, λ_feat · Σ wᵢ
  L1(VGG(fake)ᵢ, VGG(image)ᵢ) (``losses``).

The gradient groups are ("gen",) and the discriminators together, each one
``autograd.grad`` of its objective; D's group sees the fake only through
the detached pass, so it is pix2pixHD's zero_grad/backward/step of G, then
of D. The VGG trunk is no network of the trainer: it takes no Adam, is in
no group and in no checkpoint; ``load_state`` takes its weights under
``params["vgg"]`` where given (the CLI loads a torchvision state dict into
it, ``load_vgg``). The logged losses are pix2pixHD's five, in
``PIX2PIXHD_LOSS_KEYS`` order.

**Draws.** A train step draws its flips, one uniform per row above 0.5,
from the generator keyed (seed + 1, epoch, train, step, 0); none under
``--no_flip`` or in a val step.

**Epochs.** A train pass takes its rows in a fresh permutation of the split
each epoch (pix2pixHD's shuffled loader), from ``loop.epoch_rng(seed,
epoch, 0)``; a val pass in order. The full batches run through the cached
epoch runner (a CUDA graph on the card), the remainder as an eager step;
resident or streamed caches, ``fit``, ``--resume``, ``--checkpoint-every``
and the fault fence are the other trainers' (train/base.py).

Not ported: the linear decay of the learning rate over the last
``niter_decay`` epochs, data parallelism (a world above one rank is
refused), the local enhancer (``label2city_1024p``), ``--instance_feat``
and ``--label_feat``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from gan_tpu_torch.config import Pix2PixHDConfig
from gan_tpu_torch.data.labels import LABEL, RGB, hd_inputs
from gan_tpu_torch.losses import (PIX2PIXHD_LOSS_KEYS, empty_losses, feature_matching_loss,
                                  lsgan_loss, vgg_loss)
from gan_tpu_torch.models.multiscale_d import NLayerDiscriminator, multiscale
from gan_tpu_torch.models.resnet_generator import GlobalGenerator
from gan_tpu_torch.models.vgg import WEIGHTS as VGG_WEIGHTS, VGG19Trunk
from gan_tpu_torch.parallel import Replicas, single
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.base import GANTrainer, StepDraws
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.utils.grids import save_image_grid
from gan_tpu_torch.utils.profiling import span

TORCH_ADAM_EPS = 1e-8   # torch.optim.Adam's default, which pix2pixHD keeps
_FLIP = 0               # draw index within a step


def discriminator_names(num_d: int) -> tuple[str, ...]:
    return tuple(f"disc_{i}" for i in range(num_d))


def label_image(labels: np.ndarray, label_nc: int) -> np.ndarray:
    """A label map (H, W) as a gray RGB image in [-1, 1], for the grids."""
    g = labels.astype(np.float32) / max(1, label_nc - 1) * 2.0 - 1.0
    return np.repeat(g[..., None], 3, axis=2)


class Pix2PixHDTrainer(GANTrainer):
    ADAM_EPS = TORCH_ADAM_EPS

    def __init__(self, config: Pix2PixHDConfig, replicas: Optional[Replicas] = None):
        replicas = single() if replicas is None else replicas
        if replicas.size > 1:
            raise ValueError(f"pix2pixHD trains on one rank; the world has {replicas.size} "
                             "(its data parallelism is not ported)")
        init = torch.Generator().manual_seed(config.seed)   # CPU draws: same weights on any device
        self.gen = GlobalGenerator(config.input_nc, 3, ngf=config.ngf,
                                   n_downsample=config.n_downsample_global,
                                   n_blocks=config.n_blocks_global, generator=init)
        discs = {name: NLayerDiscriminator(config.input_nc + 3, ndf=config.ndf,
                                           n_layers=config.n_layers_D, generator=init)
                 for name in discriminator_names(config.num_D)}
        super().__init__(config, {"gen": self.gen, **discs}, (("gen",), tuple(discs)),
                         sampler="gen", replicas=replicas)
        self.discs = [self.nets[name] for name in discs]
        self.vgg = None if config.no_vgg_loss else VGG19Trunk(init).to(self.device)

    def load_vgg(self, path: str) -> None:
        """The VGG trunk's weights from a torchvision ``vgg19`` state dict file."""
        self.vgg.load_torchvision(torch.load(path, map_location="cpu", weights_only=True))

    # ------------------------------------------------------------------ step
    def inputs(self, u8: torch.Tensor, flip: Optional[torch.Tensor]):
        cfg = self.config
        return hd_inputs(u8, flip, label_nc=cfg.label_nc, instance=not cfg.no_instance,
                         dtype=self.dtype)

    def _losses(self, x, y, generators=None, masks=None, bn_group=None):
        """((G's objective, D's), the five losses). x: the generator's
        input; y: the image."""
        cfg, dt = self.config, self.dtype
        fake = self.gen(x, compute_dtype=dt)
        d_fake = multiscale(self.discs, torch.cat([x, fake.detach()], dim=-1), compute_dtype=dt)
        d_real = multiscale(self.discs, torch.cat([x, y], dim=-1), compute_dtype=dt)
        g_fake = multiscale(self.discs, torch.cat([x, fake], dim=-1), compute_dtype=dt)
        loss_d_fake, loss_d_real = lsgan_loss(d_fake, False), lsgan_loss(d_real, True)
        g_gan = lsgan_loss(g_fake, True)
        zero = g_gan.new_zeros(())
        g_feat = zero if cfg.no_ganFeat_loss else feature_matching_loss(
            g_fake, d_real, n_layers=cfg.n_layers_D, lam=cfg.lambda_feat)
        g_vgg = zero if self.vgg is None else vgg_loss(
            self.vgg(fake, compute_dtype=dt), self.vgg(y, compute_dtype=dt), VGG_WEIGHTS,
            lam=cfg.lambda_feat)
        losses = torch.stack([g_gan, g_feat, g_vgg, loss_d_real, loss_d_fake])
        return (g_gan + g_feat + g_vgg, (loss_d_fake + loss_d_real) * 0.5), losses

    def _flips(self, generator: torch.Generator, b: int) -> torch.Tensor:
        if self.config.no_flip:
            return torch.zeros(b, dtype=torch.bool, device=self.device)
        return torch.rand(b, generator=generator, device=self.device) > 0.5

    def _step(self, u8: torch.Tensor, epoch: int, stream: int, step: int) -> torch.Tensor:
        """The flip draw (train), the inputs, then a train or eval step.
        u8: (B, H, W, 6) uint8 rows on the device."""
        if stream == 0:
            flip = self._flips(self._draws(self.config.seed + 1, epoch, stream, step, _FLIP),
                               u8.shape[0])
            return self.train_step(*self.inputs(u8, flip))
        return self.eval_step(*self.inputs(u8, None))

    def _step_draws(self, epoch: int, stream: int, step: int) -> StepDraws:
        if stream != 0:
            return StepDraws([], [])
        key = (self.config.seed + 1, epoch, stream, step, _FLIP)
        return StepDraws([], [(self._flips(self._draws(*key), self.local_batch),)])

    def _epoch_step(self, caches, idx, draws: StepDraws, training: bool) -> torch.Tensor:
        u8 = caches[0].index_select(0, idx[0])
        if training:
            return self.train_step(*self.inputs(u8, draws.jitter[0][0]))
        return self.eval_step(*self.inputs(u8, None))

    def run_epoch(self, cache, epoch: int, *, training: bool) -> np.ndarray:
        """One pass over a uint8 cache (N, H, W, 6): a train pass in the
        epoch's permutation, a val pass in order; the full batches through
        the cached epoch runner, then the remainder as an eager step.
        ``cache`` is a tensor on the device (resident), or a host ndarray
        or FileCache (streamed). Returns (steps, 5) losses, fetched from the
        device once."""
        with span("gan_tpu_torch.epoch"):
            b = self.local_batch
            n = cache.shape[0]
            resident = isinstance(cache, torch.Tensor)
            with span("gan_tpu_torch.epoch.plan"):
                full, tail = loop.epoch_plan(n, b)
                order = (loop.epoch_rng(self.config.seed, epoch, 0).permutation(n) if training
                         else np.arange(n))
                if resident and full:
                    rows = torch.from_numpy(order[:full * b].reshape(full, b)).to(self.device)
            if resident:
                losses = []
                if full:
                    losses.append(self._cached_epoch((cache,), (rows,), epoch, training))
                if tail:
                    with span("gan_tpu_torch.step.eager"):
                        losses.append(self._step(self._tail_rows(cache, order[full * b:]),
                                                 epoch, 0 if training else 1, full)[None])
            else:
                batches = self._rank_batches(cache, order[:full * b], order[full * b:])
                losses = self._streamed_epoch((cache,), ((u8,) for u8 in batches), full, tail,
                                              epoch, training)
            if not losses:
                return np.zeros((0, len(PIX2PIXHD_LOSS_KEYS)), np.float32)
            with span("gan_tpu_torch.epoch.fetch"):
                return torch.cat(losses).cpu().numpy()

    # ------------------------------------------------------------------- fit
    def fit(self, train_cache, val_cache, test_cache: np.ndarray, output_path: str,
            checkpoint_manager: Optional[CheckpointManager] = None, start_epoch: int = 0):
        """The epoch loop of the port's other trainers from ``start_epoch``:
        a train and a val pass per epoch, a checkpoint and an
        ``epoch_{N}.png`` sample every 5 epochs, a checkpoint at the end and
        every ``--checkpoint-every`` epochs, inside the fault fence. Caches
        are (N, H, W, 6) uint8 rows (train and val may be FileCaches).
        Returns the per-epoch mean losses of train and val."""
        cfg = self.config
        print("\nTraining...\n", flush=True)
        (train_src,), (val_src,) = self._plan_caches([(train_cache,), (val_cache,)])
        start = time.time()
        train_cost = empty_losses(PIX2PIXHD_LOSS_KEYS)
        val_cost = empty_losses(PIX2PIXHD_LOSS_KEYS)

        def epoch_body(epoch: int) -> None:
            tr = self._timed_epoch(lambda: self.run_epoch(train_src, epoch, training=True),
                                   epoch, start_epoch, lambda _: train_cache.shape[0], "images")
            print("." * (tr.shape[0] // 100), end="", flush=True)
            va = self.run_epoch(val_src, epoch, training=False)
            for i, k in enumerate(PIX2PIXHD_LOSS_KEYS):
                train_cost[k].append(float(tr[:, i].mean()) if len(tr) else float("nan"))
                val_cost[k].append(float(va[:, i].mean()) if len(va) else float("nan"))
            test_img_path = os.path.join(output_path, "test_images")
            os.makedirs(test_img_path, exist_ok=True)
            if (epoch + 1) % 5 == 0 and (epoch + 1) != cfg.epochs:
                if checkpoint_manager is not None:
                    checkpoint_manager.save(epoch + 1, self.state())
                self.generate_image(test_cache[:1],
                                    os.path.join(test_img_path, f"epoch_{epoch + 1}.png"))
            if (epoch + 1) == cfg.epochs and checkpoint_manager is not None:
                checkpoint_manager.save(epoch + 1, self.state())
            self._checkpoint_every(epoch + 1, checkpoint_manager)
            g = sum(train_cost[k][-1] for k in PIX2PIXHD_LOSS_KEYS[:3])
            d = 0.5 * (train_cost["D_real"][-1] + train_cost["D_fake"][-1])
            print(f"\nCumulative training duration at end of epoch {epoch + 1}: "
                  f"{(time.time() - start) / 60:.2f} min")
            print(f"Train generator loss: {round(g, 2)}, train discriminator loss: {round(d, 2)}\n")

        self._fenced_epochs(epoch_body, checkpoint_manager, start_epoch, (train_cost, val_cost))
        return train_cost, val_cost

    # --------------------------------------------------------------- predict
    @torch.no_grad()
    def _forward(self, x: torch.Tensor, index: int, per_sample: bool) -> torch.Tensor:
        return self.gen(x, compute_dtype=self.dtype).float()

    def _generate_on_device(self, inputs: np.ndarray, chunk: int) -> torch.Tensor:
        """G's fp32 images of uint8 rows (N, H, W, 6), ``chunk`` rows at a time."""
        u8 = self._to_device(inputs)
        return torch.cat([self._forward(self.inputs(u8[lo:lo + chunk], None)[0], lo, True)
                          for lo in range(0, u8.shape[0], chunk)])

    def _panels(self, row: np.ndarray, pred: np.ndarray, with_image: bool) -> list:
        """The grid of a normalised row: the label map, the image where the
        row has one, and the prediction."""
        labels = np.rint((row[..., LABEL] + 1.0) * 127.5)
        image = [row[..., RGB]] if with_image else []
        return [label_image(labels, self.config.label_nc), *image, pred]

    def generate_image(self, rows: np.ndarray, path_filename: str) -> None:
        """Label map / image / prediction of the first row of ``rows``."""
        pred = self._generate_on_device(rows[:1], 1).cpu().numpy()
        save_image_grid(self._panels(rows[0].astype(np.float32) / 127.5 - 1.0, pred[0], True),
                        path_filename, channels="3")

    def predict(self, predict_cache, output_path: str, with_image: bool = True) -> None:
        """prediction_images/img{N}.png (label map, [image,] prediction) for
        each row of an ndarray or a FileCache (train/base.py ``_predict``)."""
        self._predict(predict_cache, output_path, False, None, inputs=lambda batch: batch,
                      panels=lambda row, pred: self._panels(row, pred, with_image))

    # ------------------------------------------------------------ state mgmt
    def load_state(self, state: dict) -> None:
        """:meth:`GANTrainer.load_state`; the VGG trunk's weights where
        ``state["params"]`` holds them under "vgg"."""
        params = dict(state["params"])
        vgg = params.pop("vgg", None)
        if vgg is not None and self.vgg is not None:
            self.vgg.load_state_dict(vgg)
        super().load_state(dict(state, params=params))
