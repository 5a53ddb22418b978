"""The reference's training steps in plain PyTorch, float32: the random
draws, the jitter, Pix2Pix's and CycleGAN's losses, their gradients and
Adam, as kingjosephm/GAN defines them and the configuration states them.

The draws are worked out again from the seed, as the program is specified
to draw them: one ``torch.Generator`` per (seed + 1, epoch, train or val,
step, index), seeded from numpy's ``SeedSequence`` of that key, on the
device the step runs on. Pix2Pix draws its dropout at index 0 and its
jitter at index 1. CycleGAN draws one dropout generator per U-Net pass and
its X and Y jitter at indices 6 and 7; its passes concatenate the images
that one generator takes (three passes) where the wider domain has at most
4 256²-image equivalents, and are the six applications otherwise, so the
keep-masks of one pass are split over the applications it holds. The
epoch's CycleGAN order is numpy's permutation of each domain, X then Y,
from ``default_rng(SeedSequence([seed mod 2**32, epoch, 0]))``.

``run_steps`` trains the first steps of an epoch and returns what the
benchmark compares: each step's losses, each parameter's first gradient
and each parameter's change over the steps, as norms per parameter.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.nets import DROP_RATE, identity

JITTER_PAD = 30
PIX2PIX_DROPOUT, PIX2PIX_JITTER = 0, 1
CYCLEGAN_JITTER = (6, 7)
BATCHED_EQUIVALENTS = 4   # 256²-images per domain up to which CycleGAN's passes are batched
# CycleGAN's passes: (generator, the images it takes, the images it makes)
BATCHED = (("gen_g", ("x", "y"), ("fake_y", "same_y")),
           ("gen_f", ("fake_y", "y", "x"), ("cycled_x", "fake_x", "same_x")),
           ("gen_g", ("fake_x",), ("cycled_y",)))
UNBATCHED = (("gen_g", ("x",), ("fake_y",)), ("gen_f", ("fake_y",), ("cycled_x",)),
             ("gen_f", ("y",), ("fake_x",)), ("gen_g", ("fake_x",), ("cycled_y",)),
             ("gen_f", ("x",), ("same_x",)), ("gen_g", ("y",), ("same_y",)))
_DOMAIN = {"x": "x", "fake_y": "x", "y": "y", "fake_x": "y"}
GROUPS = {"pix2pix": (("gen",), ("disc",)),
          "cyclegan": (("gen_g", "gen_f"), ("disc_x", "disc_y"))}


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


def cyclegan_passes(config: dict, bx: int, by: int):
    limit = int(BATCHED_EQUIVALENTS * (256 / config["img_size"]) ** 2)
    return BATCHED if max(bx, by) <= limit else UNBATCHED


def cyclegan_order(seed: int, epoch: int, nx: int, ny: int):
    rng = np.random.default_rng(np.random.SeedSequence([seed % (2**32), epoch, 0]))
    return rng.permutation(nx), rng.permutation(ny)


class Step:
    """One training step's inputs and draws for the first steps of epoch 0."""

    def __init__(self, config: dict, nets: dict, seed: int, step: int, device):
        self.config, self.nets, self.seed, self.step, self.device = config, nets, seed, step, device

    def _gen(self, index: int):
        return keyed((self.seed + 1, 0, 0, self.step, index), self.device)

    def pix2pix(self, u8: torch.Tensor):
        """(x, y, masks) of a Pix2Pix step on (B, 2, S', S', C) uint8 rows."""
        b, size = u8.shape[0], self.config["img_size"]
        masks = keep_masks(self.nets["gen"].dropout_shapes(b, size),
                           self._gen(PIX2PIX_DROPOUT), self.device)
        oh, ow, flip = jitter_draws(b, u8.shape[2], size, self._gen(PIX2PIX_JITTER), self.device)
        return crop_flip(u8[:, 0], oh, ow, flip, size), crop_flip(u8[:, 1], oh, ow, flip, size), \
            {"fake": masks}

    def cyclegan(self, u8x: torch.Tensor, u8y: torch.Tensor):
        """(x, y, masks by the image each application makes) of a CycleGAN step."""
        size, rows = self.config["img_size"], {"x": u8x.shape[0], "y": u8y.shape[0]}
        masks = {}
        for k, (net, inputs, outputs) in enumerate(cyclegan_passes(self.config, *rows.values())):
            widths = [rows[_DOMAIN[i]] for i in inputs]
            drawn = keep_masks(self.nets[net].dropout_shapes(sum(widths), size), self._gen(k),
                               self.device)
            lo = 0
            for name, w in zip(outputs, widths):
                masks[name] = [m[lo:lo + w] for m in drawn]
                lo += w
        x = crop_flip(u8x, *jitter_draws(rows["x"], u8x.shape[1], size,
                                         self._gen(CYCLEGAN_JITTER[0]), self.device), size)
        y = crop_flip(u8y, *jitter_draws(rows["y"], u8y.shape[1], size,
                                         self._gen(CYCLEGAN_JITTER[1]), self.device), size)
        return x, y, masks


def pix2pix_losses(config, nets, x, y, masks, q):
    fake = nets["gen"](x, masks["fake"], q)
    d_real, d_fake = nets["disc"](x, y, q), nets["disc"](x, fake, q)
    gan, sec = bce(1.0, d_fake), l1(y, fake)
    total = gan + float(config["lambda"]) * sec
    disc = (bce(1.0, d_real) + bce(0.0, d_fake)) * 0.5
    return (total, disc), torch.stack([total, gan, sec, disc])


def cyclegan_losses(config, nets, x, y, masks, q):
    g, f, lam = nets["gen_g"], nets["gen_f"], float(config["lambda"])
    fake_y = g(x, masks["fake_y"], q)
    cycled_x = f(fake_y, masks["cycled_x"], q)
    fake_x = f(y, masks["fake_x"], q)
    cycled_y = g(fake_x, masks["cycled_y"], q)
    same_x, same_y = f(x, masks["same_x"], q), g(y, masks["same_y"], q)
    dx_real, dx_fake = nets["disc_x"](x, q=q), nets["disc_x"](fake_x, q=q)
    dy_real, dy_fake = nets["disc_y"](y, q=q), nets["disc_y"](fake_y, q=q)
    adv_g, adv_f = bce(1.0, dy_fake), bce(1.0, dx_fake)
    cycle = lam * l1(x, cycled_x) + lam * l1(y, cycled_y)
    id_g, id_f = lam * 0.5 * l1(y, same_y), lam * 0.5 * l1(x, same_x)
    disc_x = (bce(1.0, dx_real) + bce(0.0, dx_fake)) * 0.5
    disc_y = (bce(1.0, dy_real) + bce(0.0, dy_fake)) * 0.5
    losses = torch.stack([adv_g, adv_f, cycle, adv_g + cycle + id_g, adv_f + cycle + id_f,
                          disc_x, disc_y])
    return (adv_g + adv_f + cycle + id_g + id_f, disc_x + disc_y), losses


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
    epoch 0. ``rows(s)`` gives step s's uint8 rows: Pix2Pix (B, 2, S', S',
    C), CycleGAN a pair (X, Y) of (B, S', S', C). Returns {"losses": (steps,
    K) array, "grad1": {leaf: norm of its first gradient}, "grad1_t": {leaf:
    that gradient}, "change": {leaf: norm of its change over the steps}}."""
    model = config["model"]
    device = next(next(iter(nets.values())).parameters()).device
    named = {net: list(m.named_parameters()) for net, m in nets.items()}
    start = {f"{net}.{n}": p.detach().clone() for net, ps in named.items() for n, p in ps}
    opts = {net: Adam([p for _n, p in ps], config) for net, ps in named.items()}
    out = {"losses": [], "grad1": None}
    for s in range(steps):
        draw = Step(config, nets, seed, s, device)
        if model == "pix2pix":
            objectives, losses = pix2pix_losses(config, nets, *draw.pix2pix(rows(s)), q)
        else:
            objectives, losses = cyclegan_losses(config, nets, *draw.cyclegan(*rows(s)), q)
        groups = GROUPS[model]
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
