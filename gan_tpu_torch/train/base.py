"""What the Pix2Pix and CycleGAN trainers share.

``GANTrainer`` holds the networks, one Adam per network and the draws. A
subclass builds its networks and writes ``_losses(x, y, generators)``, which
returns ({network: its total loss}, the stacked metrics); the step is then
common: each network's gradient is its own ``torch.autograd.grad`` of its
own total with respect to its own parameters, which gives the reference's
one tape per network (gan_tpu's ``sg_tree`` partition of one combined
scalar), and all gradients are taken before any network is updated.

Draws come from ``torch.Generator``s seeded as a pure function of a key
(``_draws``), so a re-run repeats them. ``generate`` keys its dropout by
(seed + 2, index), as gan_tpu folds ``PRNGKey(seed + 2)``; the bits are
torch's, not jax's, so the packages agree in distribution only.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from gan_tpu_torch.data.augment import normalize_batch
from gan_tpu_torch.device import default_device, torch_dtype
from gan_tpu_torch.train.optim import adam


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


def write_raw(preds: np.ndarray, output_path: str, png_names) -> None:
    """Bare generated images (fp32 [-1, 1] -> uint8 PNGs) in prediction_images_raw/."""
    from PIL import Image

    raw_path = os.path.join(output_path, "prediction_images_raw")
    os.makedirs(raw_path, exist_ok=True)
    u8 = np.clip((preds + 1.0) * 127.5, 0, 255).astype(np.uint8)
    for i in range(u8.shape[0]):
        arr = u8[i, :, :, 0] if u8.shape[-1] == 1 else u8[i]
        Image.fromarray(arr).save(os.path.join(raw_path, png_names[i]))


class GANTrainer:
    """``nets`` maps network names to modules, in the order the step takes
    their gradients; ``sampler`` names the generator that ``generate`` runs."""

    def __init__(self, config, nets: dict, sampler: str):
        self.config = config
        self.device = default_device()
        self.dtype = torch_dtype(config.dtype)
        self.nets = {name: net.to(self.device) for name, net in nets.items()}
        self.params = {name: list(net.parameters()) for name, net in self.nets.items()}
        self.opts = {name: adam(p, config.learning_rate, config.beta_1, config.beta_2)
                     for name, p in self.params.items()}
        self.sampler = self.nets[sampler]
        self._sample_calls = 0   # fresh dropout draws per generate() call

    # ------------------------------------------------------------------ step
    def _draws(self, seed: int, *key: int) -> torch.Generator:
        state = np.random.SeedSequence([seed, *key]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(state))

    def _losses(self, x, y, generators):
        raise NotImplementedError

    def gradients(self, x, y, generators=None):
        """({network: gradients of its total w.r.t. its parameters}, losses),
        with nothing updated. x, y: normalized (N, S, S, C) batches."""
        totals, losses = self._losses(x, y, generators)
        grads = {}
        for i, name in enumerate(self.nets):
            grads[name] = torch.autograd.grad(totals[name], self.params[name],
                                              retain_graph=i < len(self.nets) - 1)
        return grads, losses.detach()

    def apply_gradients(self, grads: dict) -> None:
        """One Adam update of each network from :meth:`gradients`' output."""
        for name, opt in self.opts.items():
            for p, g in zip(self.params[name], grads[name]):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)

    def train_step(self, x, y, generators=None) -> torch.Tensor:
        """One step of every network; returns the losses (on the device)."""
        grads, losses = self.gradients(x, y, generators)
        self.apply_gradients(grads)
        return losses

    @torch.no_grad()
    def eval_step(self, x, y, generators=None) -> torch.Tensor:
        return self._losses(x, y, generators)[1]

    # --------------------------------------------------------------- predict
    @torch.no_grad()
    def _forward(self, x: torch.Tensor, index: int, per_sample: bool) -> np.ndarray:
        out = self.sampler(x, generator=self._draws(self.config.seed + 2, index),
                           compute_dtype=self.dtype, per_sample=per_sample)
        return out.cpu().numpy()

    def generate(self, input_batch: np.ndarray, key_index: Optional[int] = None) -> np.ndarray:
        """The sampler's G(x) with training-mode semantics (dropout on, batch
        statistics). ``key_index`` selects the dropout draws; when omitted a
        per-call counter supplies it."""
        if key_index is None:
            key_index = self._sample_calls
            self._sample_calls += 1
        x = torch.from_numpy(np.ascontiguousarray(input_batch)).to(self.device, self.dtype)
        return self._forward(x, key_index, per_sample=False)

    def generate_batched(self, inputs: np.ndarray, chunk: int = 16) -> np.ndarray:
        """Chunked batched inference, exact against one forward per image:
        every norm takes each image's own statistics (batch norm through
        ``per_sample``; instance norm is per sample anyway). uint8 inputs are
        normalized to [-1, 1] on the device. Chunk dropout draws are keyed by
        the chunk offset."""
        outs = []
        for lo in range(0, inputs.shape[0], chunk):
            xs = torch.from_numpy(np.ascontiguousarray(inputs[lo:lo + chunk])).to(self.device)
            xs = normalize_batch(xs, self.dtype) if xs.dtype == torch.uint8 else xs.to(self.dtype)
            outs.append(self._forward(xs, lo, per_sample=True))
        return np.concatenate(outs, axis=0)

    # ------------------------------------------------------------ state mgmt
    def state(self) -> dict:
        """{"params": {network: state_dict}, "opt_states": {network: Adam
        state_dict}}: tensors and plain values only, for ``weights_only``."""
        return {"params": {name: net.state_dict() for name, net in self.nets.items()},
                "opt_states": {name: opt.state_dict() for name, opt in self.opts.items()}}

    def load_state(self, state: dict) -> None:
        """Load a state from :meth:`state`, or a generators-only one (what a
        predict checkpoint needs)."""
        params = state["params"]
        for name, net in self.nets.items():
            if name in params or name.startswith("gen"):
                net.load_state_dict(params[name])
        for name, opt_state in state.get("opt_states", {}).items():
            self.opts[name].load_state_dict(opt_state)
