"""CycleGAN trainer, predict slice (counterpart of gan_tpu/train/cyclegan_trainer.py).

It holds the two instance-norm U-Net generators, g: X->Y and f: Y->X, and
runs generator_g forward-only: ``generate`` / ``generate_image`` /
``generate_batched`` / ``predict``, with ``state`` / ``load_state`` for
checkpoints. Discriminators, optimizers and ``fit`` come with training.

Dropout stays on at inference, as in the reference (SURVEY §2.10 Q3). Its
masks are drawn from a ``torch.Generator`` seeded as a pure function of
(seed + 2, index), mirroring gan_tpu's ``fold_in(PRNGKey(seed + 2), index)``:
``generate`` uses the key index, ``generate_batched`` the chunk offset. The
draws are torch's, not jax's, so the two packages agree in distribution, not
bit for bit.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from gan_tpu_torch.config import CycleGANConfig
from gan_tpu_torch.data.augment import normalize_batch
from gan_tpu_torch.data.loader import iter_uint8_batches
from gan_tpu_torch.device import default_device, torch_dtype
from gan_tpu_torch.models import UNetGenerator
from gan_tpu_torch.utils.grids import save_image_grid


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
        self.gen_g.to(self.device).eval()
        self.gen_f.to(self.device).eval()
        self._sample_calls = 0   # fresh dropout draws per generate() call

    def _dropout_generator(self, index: int) -> torch.Generator:
        seed = np.random.SeedSequence([self.config.seed + 2, index]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

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

    def fit(self, *args, **kwargs):
        raise NotImplementedError("CycleGAN training is not ported to gan_tpu_torch yet "
                                  "(needs PatchGAN, losses, Adam and the instance-norm "
                                  "backward kernel); train with cycle_gan.py")

    # ------------------------------------------------------------ state mgmt
    def state(self) -> dict:
        return {"params": {"gen_g": self.gen_g.state_dict(), "gen_f": self.gen_f.state_dict()}}

    def load_state(self, state: dict) -> None:
        self.gen_g.load_state_dict(state["params"]["gen_g"])
        self.gen_f.load_state_dict(state["params"]["gen_f"])
