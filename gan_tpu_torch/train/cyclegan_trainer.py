"""CycleGAN trainer (counterpart of gan_tpu/train/cyclegan_trainer.py).

It holds the reference's four networks: the instance-norm U-Net generators
g: X→Y and f: Y→X, the PatchGAN discriminators of each domain, and one Adam
per network.

**The step.** gan_tpu makes one fused backward over a combined scalar with
every other network's parameters stop-gradiented, and lets XLA merge the
duplicated forwards. Eager PyTorch merges nothing, so here each forward runs
once: six generator applications (fake_y = G(x), cycled_x = F(fake_y),
fake_x = F(y), cycled_y = G(fake_x), same_x = F(x), same_y = G(y)) and four
discriminator ones (D_y on y and fake_y, D_x on x and fake_x). Each network's
gradient is its own ``torch.autograd.grad`` of its own total with respect to
its own parameters, which gives the reference's four tapes: the cycle loss
sits in both generator totals; the adversarial loss reaches a generator
through a discriminator whose parameters take no gradient from it; and a
discriminator's gradient stops at the fake, as if it were detached. So one
D(fake) serves both the adversarial and the discriminator loss. All four
gradients are taken before any network is updated.

**Draws.** Dropout masks and jitter offsets come from ``torch.Generator``s
seeded as a pure function of (seed + 1, epoch, train or val, step,
application), so a re-run repeats its draws, as ``loop.epoch_rng`` does for
the shuffles; ``generate`` keys its dropout by (seed + 2, index), as gan_tpu
folds ``PRNGKey(seed + 2)``. The bits are torch's, not jax's, so the two
packages agree in distribution only.

``fit`` is the simplest of gan_tpu's epoch forms: both domains' uint8 train
and val caches live whole on the device, one step per zipped batch. gan_tpu's
hybrid and streamed tiers, epoch segments and fault fence are not ported.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gan_tpu_torch.config import CycleGANConfig
from gan_tpu_torch.data.augment import normalize_batch, single_jitter_batch
from gan_tpu_torch.data.loader import iter_uint8_batches
from gan_tpu_torch.device import default_device, torch_dtype
from gan_tpu_torch.losses import (CYCLEGAN_LOSS_KEYS, cycle_loss, discriminator_loss,
                                  empty_losses, generator_adversarial_loss, identity_loss)
from gan_tpu_torch.models import PatchGANDiscriminator, UNetGenerator
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.optim import adam
from gan_tpu_torch.utils.grids import save_image_grid

NETWORKS = ("gen_g", "gen_f", "disc_x", "disc_y")
GENERATOR_APPLICATIONS = 6   # generator forwards per step, one dropout generator each
_JITTER_X, _JITTER_Y = GENERATOR_APPLICATIONS, GENERATOR_APPLICATIONS + 1   # draw indices


def generator_depth(img_size: int) -> int:
    """The reference always builds 8 down blocks; cap by log2(img_size) so
    tiny test images still bottleneck at 1×1."""
    return min(8, int(math.log2(img_size)))


def raw_png_names(names, count: int) -> list[str]:
    """Unique .png names for the raw predictions: source stems, with a
    counter suffix when two sources differ only by extension."""
    if names is None:
        return [f"img{i}.png" for i in range(count)]
    out, seen = [], {}
    for n in names:
        stem = os.path.splitext(os.path.basename(n))[0]
        k = seen.get(stem, 0)
        seen[stem] = k + 1
        out.append((stem if k == 0 else f"{stem}__{k}") + ".png")
    return out


def _write_raw(preds: np.ndarray, output_path: str, png_names) -> None:
    """Bare generated images (fp32 [-1, 1] -> uint8 PNGs) in prediction_images_raw/."""
    from PIL import Image

    raw_path = os.path.join(output_path, "prediction_images_raw")
    os.makedirs(raw_path, exist_ok=True)
    u8 = np.clip((preds + 1.0) * 127.5, 0, 255).astype(np.uint8)
    for i in range(u8.shape[0]):
        arr = u8[i, :, :, 0] if u8.shape[-1] == 1 else u8[i]
        Image.fromarray(arr).save(os.path.join(raw_path, png_names[i]))


class CycleGANTrainer:
    def __init__(self, config: CycleGANConfig):
        self.config = config
        self.device = default_device()
        self.dtype = torch_dtype(config.dtype)
        c = config.n_channels
        init = torch.Generator().manual_seed(config.seed)   # CPU draws: same weights on any device
        depth = generator_depth(config.img_size)
        self.gen_g = UNetGenerator(c, c, norm="instance", depth=depth, generator=init)
        self.gen_f = UNetGenerator(c, c, norm="instance", depth=depth, generator=init)
        self.disc_x = PatchGANDiscriminator(c, norm="instance", generator=init)
        self.disc_y = PatchGANDiscriminator(c, norm="instance", generator=init)
        self.nets = {name: getattr(self, name).to(self.device) for name in NETWORKS}
        self.params = {name: list(net.parameters()) for name, net in self.nets.items()}
        self.opts = {name: adam(p, config.learning_rate, config.beta_1, config.beta_2)
                     for name, p in self.params.items()}
        self._sample_calls = 0   # fresh dropout draws per generate() call

    # ------------------------------------------------------------------ step
    def _draws(self, seed: int, *key: int) -> torch.Generator:
        state = np.random.SeedSequence([seed, *key]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(state))

    def _losses(self, x, y, generators: Optional[Sequence[torch.Generator]]):
        """({network: its total loss}, the 7 losses in CYCLEGAN_LOSS_KEYS order).
        ``generators``: one dropout generator per generator application, in
        the order below; None turns dropout off."""
        dt = self.dtype
        lam = float(self.config.lam)
        k = list(generators) if generators is not None else [None] * GENERATOR_APPLICATIONS

        def gen(net, img, draws):
            return net(img, generator=draws, compute_dtype=dt)

        fake_y = gen(self.gen_g, x, k[0])
        cycled_x = gen(self.gen_f, fake_y, k[1])
        fake_x = gen(self.gen_f, y, k[2])
        cycled_y = gen(self.gen_g, fake_x, k[3])
        same_x = gen(self.gen_f, x, k[4])
        same_y = gen(self.gen_g, y, k[5])
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

    def gradients(self, x, y, generators=None):
        """({network: gradients of its total w.r.t. its parameters}, losses),
        with nothing updated. x, y: normalized (N, S, S, C) batches."""
        totals, losses = self._losses(x, y, generators)
        grads = {}
        for i, name in enumerate(NETWORKS):
            grads[name] = torch.autograd.grad(totals[name], self.params[name],
                                              retain_graph=i < len(NETWORKS) - 1)
        return grads, losses.detach()

    def apply_gradients(self, grads: dict) -> None:
        """One Adam update of each network from :meth:`gradients`' output."""
        for name, opt in self.opts.items():
            for p, g in zip(self.params[name], grads[name]):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)

    def train_step(self, x, y, generators=None) -> torch.Tensor:
        """One step of all four networks; returns the 7 losses (on the device)."""
        grads, losses = self.gradients(x, y, generators)
        self.apply_gradients(grads)
        return losses

    @torch.no_grad()
    def eval_step(self, x, y, generators=None) -> torch.Tensor:
        return self._losses(x, y, generators)[1]

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

    def run_epoch(self, x_dev: torch.Tensor, y_dev: torch.Tensor, epoch: int, *,
                  training: bool) -> np.ndarray:
        """One zip(X, Y) pass over uint8 caches on the device: the shorter
        domain's ceil-batched length, independent windowed shuffles per
        domain (``--buffer-size``). The last step is the zip tail, a partial
        batch whose X and Y widths may differ. Returns (steps, 7) losses,
        fetched from the device once."""
        cfg = self.config
        b = cfg.batch_size
        nx, ny = x_dev.shape[0], y_dev.shape[0]
        full, tail = loop.epoch_plan(min(nx, ny), b)
        if full + (tail > 0) == 0:
            return np.zeros((0, len(CYCLEGAN_LOSS_KEYS)), np.float32)
        stream = 0 if training else 1
        rng = loop.epoch_rng(cfg.seed, epoch, stream)
        perm_x = torch.from_numpy(loop.epoch_perm(nx, cfg.buffer_size, rng)).to(self.device)
        perm_y = torch.from_numpy(loop.epoch_perm(ny, cfg.buffer_size, rng)).to(self.device)
        losses = [self._step(x_dev[perm_x[s * b:(s + 1) * b]], y_dev[perm_y[s * b:(s + 1) * b]],
                             epoch, stream, s)
                  for s in range(full + (tail > 0))]
        return torch.stack(losses).cpu().numpy()

    # ------------------------------------------------------------------- fit
    def fit(self, train_x: np.ndarray, train_y: np.ndarray, val_x: np.ndarray,
            val_y: np.ndarray, test_cache: np.ndarray, output_path: str,
            checkpoint_manager: Optional[CheckpointManager] = None):
        """Epoch loop of the reference (cycle_gan.py:278-358). Caches from
        gan_tpu_torch.data.pipeline.build_cyclegan_cache: train
        (N, S+30, S+30, C), val and test (N, S, S, C). A checkpoint and an
        ``epoch_{N}.png`` sample every 5 epochs, a checkpoint at the end.
        Returns the per-epoch mean losses of train and val."""
        cfg = self.config
        print("\nTraining...\n", flush=True)
        example = test_cache[:1].astype(np.float32) / 127.5 - 1.0
        dev = {name: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
               for name, a in (("train_x", train_x), ("train_y", train_y),
                               ("val_x", val_x), ("val_y", val_y))}
        start = time.time()
        train_cost = empty_losses(CYCLEGAN_LOSS_KEYS)
        val_cost = empty_losses(CYCLEGAN_LOSS_KEYS)
        for epoch in range(cfg.epochs):
            tr = self.run_epoch(dev["train_x"], dev["train_y"], epoch, training=True)
            print("." * (tr.shape[0] // 100), end="", flush=True)
            va = self.run_epoch(dev["val_x"], dev["val_y"], epoch, training=False)
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
    def _dropout_generator(self, index: int) -> torch.Generator:
        return self._draws(self.config.seed + 2, index)

    @torch.no_grad()
    def _forward(self, x: torch.Tensor, index: int) -> np.ndarray:
        out = self.gen_g(x, generator=self._dropout_generator(index), compute_dtype=self.dtype)
        return out.cpu().numpy()

    def generate(self, input_batch: np.ndarray, key_index: Optional[int] = None) -> np.ndarray:
        """generator_g(x) with training-mode semantics (dropout on).
        ``key_index`` selects the dropout draws; when omitted a per-call
        counter supplies it."""
        if key_index is None:
            key_index = self._sample_calls
            self._sample_calls += 1
        x = torch.as_tensor(np.asarray(input_batch), device=self.device).to(self.dtype)
        return self._forward(x, key_index)

    def generate_image(self, input_image: np.ndarray, path_filename: str,
                       key_index: Optional[int] = None) -> None:
        """2-panel Input / Predicted grid."""
        pred = self.generate(input_image, key_index=key_index)
        save_image_grid([input_image[0], pred[0]], path_filename,
                        channels=self.config.channels)

    def generate_batched(self, inputs: np.ndarray, chunk: int = 16) -> np.ndarray:
        """Chunked batched inference; exact against per-image forwards because
        instance norm is per-sample. uint8 inputs are normalized to [-1, 1]
        on the device. Chunk dropout draws are keyed by the chunk offset."""
        outs = []
        for lo in range(0, inputs.shape[0], chunk):
            xs = torch.from_numpy(np.ascontiguousarray(inputs[lo:lo + chunk])).to(self.device)
            xs = normalize_batch(xs, self.dtype) if xs.dtype == torch.uint8 else xs.to(self.dtype)
            outs.append(self._forward(xs, lo))
        return np.concatenate(outs, axis=0)

    def predict(self, predict_cache: np.ndarray, output_path: str,
                raw: bool = False, raw_names=None) -> None:
        """prediction_images/img{N}.png via generator_g, in 64-image chunks."""
        plot_path = os.path.join(output_path, "prediction_images")
        os.makedirs(plot_path, exist_ok=True)
        n = predict_cache.shape[0]
        png_names = raw_png_names(raw_names, n) if raw else None
        off = 0
        for batch in iter_uint8_batches(predict_cache, 64):
            preds = self.generate_batched(batch)
            for i in range(batch.shape[0]):
                x = batch[i].astype(np.float32) / 127.5 - 1.0
                save_image_grid([x, preds[i]], os.path.join(plot_path, f"img{off + i}.png"),
                                channels=self.config.channels)
            if raw:
                _write_raw(preds, output_path, png_names[off:off + batch.shape[0]])
            off += batch.shape[0]

    # ------------------------------------------------------------ state mgmt
    def state(self) -> dict:
        """{"params": {network: state_dict}, "opt_states": {network: Adam
        state_dict}}: tensors and plain values only, for ``weights_only``."""
        return {"params": {name: net.state_dict() for name, net in self.nets.items()},
                "opt_states": {name: opt.state_dict() for name, opt in self.opts.items()}}

    def load_state(self, state: dict) -> None:
        """Load a state from :meth:`state`, or a generators-only one (what
        predict checkpoints of the port's first slice hold)."""
        params = state["params"]
        for name, net in self.nets.items():
            if name in params or name.startswith("gen_"):
                net.load_state_dict(params[name])
        for name, opt_state in state.get("opt_states", {}).items():
            self.opts[name].load_state_dict(opt_state)
