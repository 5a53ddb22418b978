"""The reference's training steps in plain PyTorch, float32: the random
draws, the jitter, the losses' parts, the gradients and Adam, as
kingjosephm/GAN defines them and the configuration states them. Each model's
draws, passes and losses are in ``portbench/reference/<model>.py``, found
through ``portbench.models``.

The draws are worked out again from the seed, as the program is specified
to draw them: one ``torch.Generator`` per (seed + 1, epoch, train or val,
step, index), seeded from numpy's ``SeedSequence`` of that key, on the
device the step runs on (``Step.gen``); the model says which index draws
what.

``run_steps`` trains the first steps of an epoch and returns what the
benchmark compares: each step's losses, each trained parameter's first
gradient and each trained parameter's change over the steps, as norms per
parameter.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.nets import DROP_RATE, identity


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to a float8 ``dtype`` with a per-tensor scale that maps its
    largest magnitude to the format's largest, ``top``."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t.detach() / scale).to(dtype).to(t.dtype) * scale


class _Fp8Output(torch.autograd.Function):
    """A conv's output in float8 e4m3, whose gradient is rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return _round(y, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, dy):
        return _round(dy, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """The control: every conv computed in float8 as fp8 training does it, its
    operands and its output in e4m3 and its output's gradient, which both
    backward convs take, in e5m2, each with a per-tensor scale: where the
    program holds a conv's tensors in bf16, the control holds them in fp8.
    The operands' rounding passes the gradient through unchanged."""
    return t + (_round(t, torch.float8_e4m3fn, 448.0) - t.detach())


fp8.grad = _Fp8Output.apply


def keyed(key, device) -> torch.Generator:
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def keep_masks(shapes, generator, device) -> list[torch.Tensor]:
    return [torch.rand(s, generator=generator, device=device) < 1.0 - DROP_RATE for s in shapes]


def jitter_draws(b: int, src: int, size: int, generator, device):
    limit = src - size + 1
    oh = torch.randint(0, limit, (b,), generator=generator, device=device)
    ow = torch.randint(0, limit, (b,), generator=generator, device=device)
    flip = torch.rand(b, generator=generator, device=device) > 0.5
    return oh, ow, flip


def crop_flip(u8: torch.Tensor, oh, ow, flip, size: int) -> torch.Tensor:
    """out[b, i, k] = u8[b, oh[b] + i, ow[b] + (size - 1 - k if flip[b] else k)],
    as fp32 in [-1, 1]."""
    out = torch.empty((u8.shape[0], size, size, u8.shape[-1]), dtype=torch.float32,
                      device=u8.device)
    for b in range(u8.shape[0]):
        img = u8[b, int(oh[b]):int(oh[b]) + size, int(ow[b]):int(ow[b]) + size]
        if bool(flip[b]):
            img = img.flip(1)
        out[b] = img.float()
    return out / 127.5 - 1.0


def bce(label: float, logits):
    z = logits
    return (z.clamp_min(0.0) - z * label + torch.log1p(torch.exp(-z.abs()))).mean()


def l1(a, b):
    return (a - b).abs().mean()


def device_of(nets: dict) -> torch.device:
    return next(next(iter(nets.values())).parameters()).device


class Step:
    """One training step's draws for the first steps of epoch 0."""

    def __init__(self, config: dict, nets: dict, seed: int, step: int, device):
        self.config, self.nets, self.seed, self.step, self.device = config, nets, seed, step, device

    def gen(self, index: int) -> torch.Generator:
        """The generator of the step's draw ``index``."""
        return keyed((self.seed + 1, 0, 0, self.step, index), self.device)


class Adam:
    """tf.keras' Adam: m̂ / (√v̂ + ε), one per network."""

    def __init__(self, params, config: dict):
        self.params = list(params)
        self.lr, self.b1, self.b2 = config["learning_rate"], config["beta_1"], config["beta_2"]
        self.eps = config["adam_epsilon"]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def leaf_norms(named) -> dict:
    return {name: float(t.double().norm()) for name, t in named}


def run_steps(config: dict, nets: dict, rows, seed: int, steps: int = 3, q=identity) -> dict:
    """Trains ``nets`` (weights loaded) through the first ``steps`` steps of
    epoch 0, each network of the model's ``trained`` with its own Adam; the
    others stay as loaded. ``rows(s)`` gives step s's uint8 rows in the
    form the model's ``losses`` takes. Returns {"losses": (steps, K)
    array, "grad1": {leaf: norm of its first gradient}, "grad1_t": {leaf:
    that gradient}, "change": {leaf: norm of its change over the steps}},
    over the trained networks' leaves."""
    from portbench import models
    model = models.get(config["model"])
    trained = set(model.trained(config))
    named = {net: list(m.named_parameters()) for net, m in nets.items() if net in trained}
    start = {f"{net}.{n}": p.detach().clone() for net, ps in named.items() for n, p in ps}
    opts = {net: Adam([p for _n, p in ps], config) for net, ps in named.items()}
    out = {"losses": [], "grad1": None}
    for s in range(steps):
        objectives, losses = model.losses(config, nets, rows(s), seed, s, q)
        groups = model.groups
        grads = {}
        for i, (group, objective) in enumerate(zip(groups, objectives)):
            flat = torch.autograd.grad(objective, [p for net in group for _n, p in named[net]],
                                       retain_graph=i < len(groups) - 1)
            for net in group:
                grads[net], flat = flat[:len(named[net])], flat[len(named[net]):]
        if s == 0:
            out["grad1_t"] = {f"{net}.{n}": g.detach() for net in named
                              for (n, _p), g in zip(named[net], grads[net])}
            out["grad1"] = leaf_norms(out["grad1_t"].items())
        for net, opt in opts.items():
            opt.step(grads[net])
        out["losses"].append(losses.detach().double().cpu().numpy())
    out["losses"] = np.stack(out["losses"])
    out["change"] = leaf_norms((f"{net}.{n}", p.detach() - start[f"{net}.{n}"])
                               for net, ps in named.items() for n, p in ps)
    return out
