"""``--remat`` in the port on the CPU: gradient checkpointing of the U-Net
blocks (``UNetGenerator(remat=True)``) and its ``auto`` policy
(``use_remat``). At 64² the U-Net has depth 6, the smallest with a dropout
block; batches of at most 2, fp32, dropout on with injected masks.

- one step of each trainer with remat on equals the remat-free step bit for
  bit (losses, gradients, updated parameters, Adam's state), and it
  recomputes the blocks ``chip_smoke.py`` derives as launches;
- the port with remat on against gan_tpu with ``remat="on"``: one step's
  gradients and losses of each trainer on transplanted weights and the
  same masks, at the tolerances of the remat-free step tests;
- ``use_remat``'s decision table;
- a mask drawn from a generator is drawn once, before the checkpointed
  blocks, so a recomputed block reads the same mask;
- predict (no autograd) is unchanged by the flag;
- both CLIs with ``--remat on`` write gan_tpu's config.json and build
  remat generators.
"""

import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gan_tpu.models.blocks as jax_blocks
from gan_tpu import config as jax_config
from gan_tpu.models import PatchGANDiscriminator as JaxPatchGAN
from gan_tpu.models import UNetGenerator as JaxUNet
from gan_tpu.parallel.mesh import make_mesh
from gan_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxCycleGAN
from gan_tpu.train.pix2pix_trainer import Pix2PixTrainer as JaxPix2Pix

import chip_smoke
from gan_tpu_torch import cycle_gan, pix2pix
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.data.loader import DEVICE_CACHE_FRACTION
from gan_tpu_torch.models import UNetGenerator, blocks, unet
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer, pass_widths
from gan_tpu_torch.train.pix2pix_trainer import REMAT_FREE_PEAK, Pix2PixTrainer, use_remat
from gan_tpu_torch.transplant import state_dict_to_params
from test_torch_epoch import _write_data
from test_torch_pix2pix import _two_pass_batch_norm
from torch_inputs import limit_threads

limit_threads()

SIZE = 64
DEPTH = 6
TRAINERS = ("pix2pix", "cyclegan")
GIB = 2**30


def _cfg(kind, remat, *extra, size=SIZE, batch=2):
    common = ["--output", "o", "--train", "--epochs", "1", "--img-size", str(size),
              "--batch-size", str(batch), "--dtype", "fp32", "--remat", remat, *extra]
    if kind == "pix2pix":
        return parse_pix2pix(["--data", "d", *common])
    return parse_cyclegan(["--input-images", "x", "--target-images", "y", *common])


def _trainer(kind, remat):
    return (Pix2PixTrainer if kind == "pix2pix" else CycleGANTrainer)(_cfg(kind, remat))


def _xy(seed=21, size=SIZE):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (2, size, size, 1)).astype(np.float32) for _ in range(2)]


def _masks(trainer, mask):
    """``StepDraws.masks`` of ``trainer``'s step at batch 2 with ``mask`` (2
    rows) at every image pair's one dropout site: Pix2Pix's one generator
    pass, or each pass of the CycleGAN form the trainer runs at batch 2 (4,
    6 and 2 rows batched, 2 each unbatched)."""
    if isinstance(trainer, Pix2PixTrainer):
        return [[torch.from_numpy(mask)]]
    return [[torch.from_numpy(np.tile(mask, (w // 2, 1, 1, 1)))]
            for w in pass_widths(trainer.passes(2, 2), 2, 2)]


def _assert_states_equal(a, b):
    for name in a.nets:
        for (ka, va), (kb, vb) in zip(a.nets[name].state_dict().items(),
                                      b.nets[name].state_dict().items()):
            assert ka == kb and torch.equal(va, vb), (name, ka)
        sa, sb = a.opts[name].state_dict()["state"], b.opts[name].state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for k, v in sa[i].items():
                assert torch.equal(v, sb[i][k]), (name, i, k)


@pytest.mark.parametrize("kind", TRAINERS)
def test_remat_step_equals_the_remat_free_step(monkeypatch, kind):
    """One step with injected masks: losses and gradients, then the
    parameters and Adam's state after the update, bit for bit. The
    recompute runs the same arithmetic on the same inputs. The remat
    generators checkpoint their 11 blocks per forward."""
    calls = []
    real = unet.checkpoint
    monkeypatch.setattr(unet, "checkpoint", lambda fn, *a, **kw: calls.append(fn) or real(
        fn, *a, **kw))
    on, off = _trainer(kind, "on"), _trainer(kind, "off")
    assert on.sampler.remat and not off.sampler.remat
    x, y = (torch.from_numpy(a) for a in _xy())
    mask = np.random.default_rng(22).random((2, 2, 2, 512)) < 0.5
    got = on.gradients(x, y, masks=_masks(on, mask))
    forwards = 1 if kind == "pix2pix" else len(on.passes(2, 2))
    assert len(calls) == forwards * (2 * DEPTH - 1)
    calls.clear()
    want = off.gradients(x, y, masks=_masks(off, mask))
    assert not calls
    assert torch.equal(got[1], want[1])
    for name in on.nets:
        assert all(torch.equal(g, w) for g, w in zip(got[0][name], want[0][name])), name
    on.apply_gradients(got[0])
    off.apply_gradients(want[0])
    _assert_states_equal(on, off)


@pytest.mark.parametrize("kind", TRAINERS)
def test_remat_step_recomputes_the_derived_launches(monkeypatch, kind):
    """Every stem and instance-norm forward of one train step with remat on,
    recomputes included, and every backward through a norm, as
    chip_smoke.py derives the launches of S, K1 and K2 on the card. At 32²
    (depth 5, no dropout block) a U-Net has 8 norms and a PatchGAN 3.
    Pix2Pix at batch 2 (batch norm: no K1) and at batch 1 (per-image batch
    norm through K1's wrapper); CycleGAN at batch 2 in both forms."""
    counts = {"stem_conv": 0, "instance_norm_fwd": 0, "instance_norm_bwd": 0}
    real_stem, real_norm = blocks.stem_conv, blocks.instance_norm

    def stem(*a, **kw):
        counts["stem_conv"] += 1
        return real_stem(*a, **kw)

    def instance_norm(*a, **kw):
        counts["instance_norm_fwd"] += 1
        y = real_norm(*a, **kw)
        if y.requires_grad:
            y.register_hook(lambda g: counts.__setitem__("instance_norm_bwd",
                                                         counts["instance_norm_bwd"] + 1))
        return y

    monkeypatch.setattr(blocks, "stem_conv", stem)
    monkeypatch.setattr(blocks, "instance_norm", instance_norm)
    trainer = (Pix2PixTrainer if kind == "pix2pix" else CycleGANTrainer)(
        _cfg(kind, "on", size=32))
    x, y = (torch.from_numpy(a) for a in _xy(size=32))
    if kind == "pix2pix":
        for b in (2, 1):
            counts.update(stem_conv=0, instance_norm_fwd=0, instance_norm_bwd=0)
            trainer.gradients(x[:b], y[:b])
            assert counts == chip_smoke.pix2pix_launches(32, b, True, remat=True), b
        return
    # the batched form recomputes its 3 generator passes, the unbatched its 6
    for limit, batched, want in ((16, True, (54, 36)), (-1, False, (108, 66))):
        trainer.BATCHED_PASS_MAX = limit
        counts.update(stem_conv=0, instance_norm_fwd=0, instance_norm_bwd=0)
        trainer.gradients(x, y)
        # a recomputed norm's output takes no gradient: count K2 at the forward's
        assert counts == chip_smoke.cyclegan_launches(32, batched, remat=True)[0]
        assert chip_smoke.train_step_launches(8, 3, batched, remat=True) == want


def _jax_trainer(monkeypatch, kind, params):
    """gan_tpu's trainer at 64², fp32, batch 2, ``remat="on"``. Its models'
    ``init`` returns the port's ``params`` (transplanted), which skips
    jax.random's per-shape compiles; the step takes ``params`` anyway."""
    gen, disc = ("gen", "disc") if kind == "pix2pix" else ("gen_g", "disc_x")
    monkeypatch.setattr(JaxUNet, "init", lambda self, key, c: params[gen])
    monkeypatch.setattr(JaxPatchGAN, "init", lambda self, key, c: params[disc])
    common = dict(output="", img_size=SIZE, batch_size=2, train=True, epochs=1, dtype="fp32",
                  num_devices=1, remat="on")
    if kind == "pix2pix":
        jcfg = jax_config.Pix2PixConfig(data="", **common)
        jcfg.validate()
        trainer = JaxPix2Pix(jcfg, mesh=make_mesh(1))
    else:
        jcfg = jax_config.CycleGANConfig(input_images="", target_images="", lam=10, **common)
        jcfg.validate()
        trainer = JaxCycleGAN(jcfg, mesh=make_mesh(1))
    assert trainer.gen.remat
    return trainer


def _leaves(tree):
    return [np.asarray(a) for _, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("kind", TRAINERS)
def test_remat_step_matches_gan_tpu_with_remat(monkeypatch, kind):
    """One full step with remat on in both packages, on transplanted weights
    and the same keep-mask at every dropout site (gan_tpu's dropout is
    replaced by one that takes it; gan_tpu's batched CycleGAN passes at
    batch 2, and the port's passes of the form its switch selects there,
    take it tiled over each pass's rows): gradients against ``jax.grad`` of gan_tpu's
    combined loss, and the losses.
    Tolerances of the remat-free step tests (tests/test_torch_pix2pix.py,
    tests/test_torch_train.py), for fp32 sums in other orders: Pix2Pix
    losses 1e-5 relative and gradients 1e-4 relative L2 per network
    (gan_tpu's batch norm given the two-pass variance there too; seen
    2.5e-5), CycleGAN 1e-4 and 1e-2, the bound for a LeakyReLU input within
    fp32 noise of 0 that takes the other slope in one package (seen 6.4e-4:
    a few channels of the port's first down blocks, against its own float64
    run, with or without remat). Adam's update of these gradients is the
    remat-free step's, which those tests hold."""
    mask = np.random.default_rng(24).random((2, 2, 2, 512)) < 0.5

    def injected_dropout(h, rate, rng_key):
        keep = 1.0 - rate
        tiled = jnp.asarray(np.tile(mask, (h.shape[0] // mask.shape[0], 1, 1, 1)))
        return jnp.where(tiled, h / jnp.asarray(keep, h.dtype), jnp.zeros((), h.dtype))

    monkeypatch.setattr(jax_blocks, "dropout", injected_dropout)
    if kind == "pix2pix":
        monkeypatch.setattr(jax_blocks, "batch_norm", _two_pass_batch_norm)
    trainer = _trainer(kind, "on")
    chip_smoke.offsets_from_seed(trainer)   # trained offsets and betas are not 0
    params = {name: state_dict_to_params(net.state_dict()) for name, net in trainer.nets.items()}
    jax_trainer = _jax_trainer(monkeypatch, kind, params)
    x, y = _xy(26)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    key = jax.random.PRNGKey(0)   # feeds only the replaced dropout
    want_grads, want_losses = jax.jit(jax.grad(jax_trainer._losses, has_aux=True))(
        params, jx, jy, key)
    got_grads, got_losses = trainer.gradients(torch.from_numpy(x), torch.from_numpy(y),
                                              masks=_masks(trainer, mask))
    loss_tol, grad_tol = (1e-5, 1e-4) if kind == "pix2pix" else (1e-4, 1e-2)
    for name in trainer.nets:
        named = dict(zip([k for k, _ in trainer.nets[name].named_parameters()], got_grads[name]))
        want, got = _leaves(want_grads[name]), _leaves(state_dict_to_params(named))
        err = math.sqrt(sum(np.square(g - w).sum() for g, w in zip(got, want)))
        norm_w = math.sqrt(sum(np.square(w).sum() for w in want))
        assert err <= grad_tol * norm_w, (name, err / norm_w)
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=loss_tol)


# the memory torch reports on an H100 80GB HBM3 (chip_smoke.py phase 14f)
H100_BYTES = int(79.18 * 2**30)
# the remat-free peaks, GiB, that chip_smoke.py phase 14f measured at each
# frontier point on an NVIDIA H100 80GB HBM3 at 700 W, above what was
# allocated before the trainer was built
MEASURED_PEAK_GIB = {("pix2pix", 512, 1): 1.14, ("pix2pix", 512, 4): 1.70,
                     ("pix2pix", 512, 16): 3.95, ("pix2pix", 512, 64): 12.92,
                     ("pix2pix", 256, 128): 6.92, ("cyclegan", 512, 1): 2.77,
                     ("cyclegan", 512, 4): 5.12, ("cyclegan", 512, 16): 13.39,
                     ("cyclegan", 512, 48): 35.52, ("cyclegan", 512, 64): 46.56,
                     ("cyclegan", 512, 72): 52.12}


@pytest.mark.parametrize("kind", TRAINERS)
def test_use_remat_decision_table(kind):
    """``on`` and ``off`` as given, whatever the size and memory; ``auto``
    where the remat-free peak that REMAT_FREE_PEAK predicts exceeds the
    share of the card's memory left beside the device caches. The line
    under-predicts none of the frontier's measured peaks, so on an H100
    80GB ``auto`` is on at exactly the frontier points whose measured peak
    exceeds that share (CycleGAN at 512², batch 72), and off at the others,
    where gan_tpu's v5e rule turned it on at 512² batches of 8 or less; it
    turns on past the predicted peak, at a larger batch on a larger card."""
    for remat in ("on", "off"):
        for size, batch, memory in ((256, 1, H100_BYTES), (512, 4096, 1 << 30)):
            assert use_remat(_cfg(kind, remat, size=size, batch=batch), memory) == (remat == "on")
    auto = lambda size, batch, memory=H100_BYTES: use_remat(
        _cfg(kind, "auto", size=size, batch=batch), memory)
    frontier = [(size, batch) for k, size, batch in chip_smoke.FRONTIER if k == kind]
    assert sorted(frontier) == sorted((s, b) for k, s, b in MEASURED_PEAK_GIB if k == kind)
    fixed, per_image = REMAT_FREE_PEAK[kind]
    budget = (1 - DEVICE_CACHE_FRACTION) * H100_BYTES
    for size, batch in frontier:
        peak = MEASURED_PEAK_GIB[kind, size, batch] * GIB
        assert fixed + per_image * batch * (size / 256) ** 2 >= peak, (size, batch)
        assert auto(size, batch) == (peak > budget), (size, batch)
    assert any(auto(s, b) for s, b in frontier) == (kind == "cyclegan")
    for batch in (1, 2, 4, 8):   # the v5e rule's "on" at 512²
        assert not auto(512, batch)
    first_on = math.floor((budget - fixed) / per_image / 4) + 1   # 512² batch, 4 equivalents each
    assert not auto(512, first_on - 1) and auto(512, first_on)
    assert auto(256, 4 * first_on) and not auto(256, 4 * (first_on - 1))
    for memory in (16 * GIB, 40 * GIB, 80 * GIB, 160 * GIB):   # once on, on at larger batches
        flags = [auto(512, b, memory) for b in range(1, 4 * first_on, 7)]
        assert flags == sorted(flags)
    assert auto(512, first_on // 2, H100_BYTES // 2) and not auto(512, first_on, 2 * H100_BYTES)


def test_remat_draws_each_dropout_mask_once(monkeypatch):
    """A generator-drawn mask is drawn before the first block: once per
    dropout site, not again when the backward recomputes the block, so the
    remat U-Net's gradient equals the remat-free one's with the same
    generator seed, bit for bit, and equals the one with those masks passed
    in."""
    draws = []
    real = blocks.keep_mask
    monkeypatch.setattr(blocks, "keep_mask", lambda *a, **kw: draws.append(a[0]) or real(*a, **kw))
    x = torch.from_numpy(np.random.default_rng(27).uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(
        np.float32))
    grads = {}
    for remat in (True, False):
        gen = UNetGenerator(1, 1, norm="instance", depth=DEPTH,
                            generator=torch.Generator().manual_seed(28), remat=remat)
        draws.clear()
        out = gen(x, generator=torch.Generator().manual_seed(29))
        grads[remat] = torch.autograd.grad(out.square().sum(), list(gen.parameters()))
        assert draws == gen.dropout_shapes(2, SIZE) == [(2, 2, 2, 512)]
    masks = [real(s, torch.Generator().manual_seed(29), x.device) for s in draws]
    passed = torch.autograd.grad(gen(x, masks=masks).square().sum(), list(gen.parameters()))
    for a, b, c in zip(grads[True], grads[False], passed):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("kind", TRAINERS)
def test_predict_is_unchanged_by_remat(monkeypatch, kind):
    """Without autograd (predict, ``generate_batched``) remat checkpoints
    nothing and the output equals the remat-free one bit for bit."""
    calls = []
    monkeypatch.setattr(unet, "checkpoint", lambda *a, **kw: calls.append(a))
    u8 = np.random.default_rng(30).integers(0, 256, (3, SIZE, SIZE, 1), dtype=np.uint8)
    on, off = _trainer(kind, "on"), _trainer(kind, "off")
    got = on.generate_batched(u8, chunk=2)
    assert not calls and got.shape == (3, SIZE, SIZE, 1)
    np.testing.assert_array_equal(got, off.generate_batched(u8, chunk=2))


class _FitReached(Exception):
    """Raised in place of ``fit``: the CLI got past config.json and the build."""


@pytest.mark.parametrize("kind", TRAINERS)
def test_clis_write_remat_on_into_config_json(tmp_path, monkeypatch, kind):
    """``--train --remat on`` through each CLI at 32², up to ``fit``:
    config.json as gan_tpu's parser writes it for the same flags, and every
    generator the run builds checkpoints its blocks."""
    built = []
    real_init = UNetGenerator.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        built.append(self.remat)

    def fit(self, *a, **kw):
        raise _FitReached

    monkeypatch.setattr(UNetGenerator, "__init__", init)
    monkeypatch.setattr(Pix2PixTrainer if kind == "pix2pix" else CycleGANTrainer, "fit", fit)
    argv = [*_write_data(tmp_path, kind), "--output", str(tmp_path / "out"), "--train",
            "--epochs", "1", "--img-size", "32", "--batch-size", "2", "--test-img", "1",
            "--dtype", "fp32", "--logging", "false", "--remat", "on"]
    with pytest.raises(_FitReached):
        if kind == "pix2pix":
            pix2pix.main(parse_pix2pix(argv))
        else:
            cycle_gan.main(parse_cyclegan(argv))
    want = (jax_config.parse_pix2pix if kind == "pix2pix" else jax_config.parse_cyclegan)(argv)
    (run,) = glob.glob(str(tmp_path / "out" / "*"))
    with open(os.path.join(run, "logs", "config.json")) as f:
        got = f.read()
    assert got == want.to_json() and json.loads(got)["remat"] == "on"
    assert built == [True] * (1 if kind == "pix2pix" else 2)
