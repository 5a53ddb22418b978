"""The port's Pix2Pix slice against gan_tpu's on the CPU: the stem kernel's
plain version (against gan_tpu's conv and LeakyReLU, and against the Pallas
stem kernel in interpret mode), the stem's backward, batch norm and its
per-image form, SSIM and the losses, the paired jitter, the split and the
caches, the flags, three full train steps on transplanted weights, the
step's stem and norm counts, and the ``--train`` / ``--predict`` CLI. Inputs
come from numpy seeds; each tolerance is stated beside its assertion. At 32²
the U-Net has depth 5 and no dropout block."""

import dataclasses
import glob
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gan_tpu.models.blocks as jax_blocks
from gan_tpu import config as jax_config
from gan_tpu import losses as jax_losses
from gan_tpu.data import augment as jax_augment
from gan_tpu.data import pipeline as jax_pipeline
from gan_tpu.data.split import pix2pix_split as jax_pix2pix_split
from gan_tpu.ops import conv as jax_conv
from gan_tpu.ops import norm as jax_norm
from gan_tpu.parallel.mesh import make_mesh
from gan_tpu.train.pix2pix_trainer import Pix2PixTrainer as JaxTrainer

import chip_smoke
from gan_tpu_torch import losses
from gan_tpu_torch.config import Pix2PixConfig, parse_pix2pix
from gan_tpu_torch.data.augment import paired_jitter_batch
from gan_tpu_torch.data.pipeline import build_pix2pix_cache
from gan_tpu_torch.data.split import pix2pix_split
from gan_tpu_torch.models import blocks
from gan_tpu_torch.ops import conv, kernels, norm, ssim
from gan_tpu_torch.train.pix2pix_trainer import NETWORKS, Pix2PixTrainer
from gan_tpu_torch.transplant import _TO_TORCH, networks_to_state_dicts, state_dict_to_params
from torch_inputs import limit_threads, norm_inputs

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jax_ssim = importlib.import_module("gan_tpu.ops.ssim")   # the package exports a function of that name


def _stem_inputs(shape, seed=0):
    """x ~ U(-1, 1) NHWC and an HWIO (4, 4, C_in, 64) weight ~ N(0, 0.02²)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = (0.02 * rng.standard_normal((4, 4, shape[-1], 64))).astype(np.float32)
    return x, w


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(_TO_TORCH)))


@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
def test_plain_stem_matches_gan_tpu(c_in):
    """fp32: both sides sum 16·C_in products in fp32 in other orders (1e-5)."""
    x, w = _stem_inputs((2, 32, 32, c_in))
    want = np.asarray(jax_blocks.leaky_relu(jax_conv.conv2d_down(jnp.asarray(x), jnp.asarray(w))))
    got = conv.stem_conv(torch.from_numpy(x), _oihw(w))
    assert got.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = kernels.LAUNCHES["stem_conv"]
    torch.testing.assert_close(kernels.stem_conv(torch.from_numpy(x), _oihw(w)), got,
                               rtol=0, atol=0)
    assert kernels.LAUNCHES["stem_conv"] == before


def _pallas_stem_proto():
    spec = importlib.util.spec_from_file_location(
        "pallas_stem_proto", os.path.join(REPO, "benchmarks", "pallas_stem_proto.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("c_in,batch,size", [(1, 2, 64), (2, 2, 64), (1, 1, 32)])
def test_plain_stem_matches_pallas_stem_kernel(c_in, batch, size):
    """The Pallas kernel S in interpret mode, at its prototype's own shapes
    (pallas_stem_proto.check), its NHCW output transposed to NHWC. bf16 taps,
    fp32 sums, one bf16 rounding on each side at other points (the plain
    version rounds the conv, then the slope): the prototype's own bound, 2e-2
    of the largest output."""
    proto = _pallas_stem_proto()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, size, size, c_in)).astype(np.float32)
    w = (rng.normal(size=(4, 4, c_in, 64)) * 0.02).astype(np.float32)
    want = np.asarray(proto.stem_conv_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True),
                      np.float32).transpose(0, 1, 3, 2)
    got = kernels.stem_conv(torch.from_numpy(x), _oihw(w), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < 2e-2, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_stem_backward_matches_autograd_of_plain(monkeypatch, dtype):
    """``StemConvFunction``'s backward (dy masked by the slope, then cuDNN's
    convolution_backward) against autograd of the plain version, with the
    forward launch replaced by the plain forward, which this CPU lacks the
    kernel for. fp32: the same convolution_backward, sums in other orders
    (1e-5). bf16: the same bf16 ops; the masked dy rounds identically."""
    monkeypatch.setattr(kernels, "_launch_stem",
                        lambda x, w: conv.stem_conv(x, w))
    x, w = _stem_inputs((2, 16, 16, 2), seed=1)
    dy = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 8, 8, 64))
                          .astype(np.float32)).to(dtype)
    grads = []
    for fn in (kernels.StemConvFunction.apply, conv.stem_conv):
        xt = torch.from_numpy(x).requires_grad_()
        wt = _oihw(w).requires_grad_()
        y = fn(xt.to(dtype), wt.to(dtype))
        grads.append(torch.autograd.grad(y, (xt, wt), dy))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 1, 1, 512), (3, 4, 5, 80)], ids=str)
def test_batch_norm_matches_gan_tpu(shape, dtype):
    """Two-pass variance (port) against gan_tpu's E[x²] − mean², x ~ N(1, 3²).
    fp32: sums in other orders (2e-5), plus the cancellation in E[x²] −
    mean², which at the 1×1 bottleneck's 2 values per channel can leave a
    variance of 1e-4 off by a few ulps of E[x²]: an error δ in the variance
    moves y by ½·|γ(x − mean)|·(var + eps)^-3/2·δ, with δ ≤ 2^-21·E[x²].
    bf16: the same bf16 input and fp32 math; the one output rounding may
    land one ulp apart (2^-7), on top of that."""
    x, gamma, beta = norm_inputs(shape, seed=5)
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax_norm.batch_norm(jnp.asarray(x).astype(jdt), jnp.asarray(gamma),
                                          jnp.asarray(beta)), np.float32)
    got = norm.batch_norm(xt, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == dtype
    x64 = xt.double().numpy()
    mean, mean_sq = x64.mean(axis=(0, 1, 2)), np.square(x64).mean(axis=(0, 1, 2))
    var = x64.var(axis=(0, 1, 2))
    cancel = 0.5 * np.abs(gamma * (x64 - mean)) * (var + norm.BN_EPS) ** -1.5 * 2.0 ** -21 * mean_sq
    tol = 2e-5 + 1e-5 * np.abs(want) + cancel
    if dtype == torch.bfloat16:
        tol = tol + 1e-3 + 2 ** -7 * np.abs(want)
    d = np.abs(got.float().numpy() - want)
    assert (d <= tol).all(), (d.max(), (d - tol).max())
    # the module: batch statistics, or each image's own with per_sample (K1's
    # plain version with batch norm's epsilon)
    bn = blocks.BatchNorm(shape[-1])
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(gamma))
        bn.beta.copy_(torch.from_numpy(beta))
        torch.testing.assert_close(bn(xt), got, rtol=0, atol=0)
        per_image = torch.cat([norm.batch_norm(xt[i:i + 1], bn.gamma, bn.beta)
                               for i in range(shape[0])])
        torch.testing.assert_close(bn(xt, per_sample=True), per_image, rtol=0, atol=0)


def _jax_trainer(generator_loss="l1", seed=0):
    """gan_tpu's Pix2PixTrainer at 32², fp32, batch 2, and its params with
    non-zero batch-norm betas (at init they are 0, and per-image batch norm at
    the 1×1 bottleneck returns beta exactly)."""
    jcfg = jax_config.Pix2PixConfig(data="", output="", img_size=32, batch_size=2, train=True,
                                    epochs=1, dtype="fp32", num_devices=1,
                                    generator_loss=generator_loss)
    jcfg.validate()
    jax_trainer = JaxTrainer(jcfg, mesh=make_mesh(1))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key in ("beta", "bias") else np.asarray(a), jax.device_get(jax_trainer.params))
    return jax_trainer, params


def _cfg(*extra):
    return parse_pix2pix(["--data", "d", "--output", "o", "--train", "--epochs", "1",
                          "--img-size", "32", "--batch-size", "2", "--dtype", "fp32", *extra])


def test_generate_batched_per_image_batch_norm_matches_gan_tpu(monkeypatch):
    """gan_tpu vmaps its generator over batch-1 sub-batches; the port runs
    the chunk with per-image statistics through the kernel wrapper's CPU path
    (8 norm sites at depth 5). fp32, sums in other orders and the two
    variance forms (seen 5e-7)."""
    jax_trainer, params = _jax_trainer(seed=1)
    jax_trainer.params = params
    trainer = Pix2PixTrainer(_cfg())
    trainer.load_state({"params": networks_to_state_dicts(params)})
    calls = []
    monkeypatch.setattr(blocks, "instance_norm",
                        lambda *a, **kw: calls.append(kw["eps"]) or kernels.instance_norm(*a, **kw))
    u8 = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 1), dtype=np.uint8)
    got = trainer.generate_batched(u8, chunk=2)
    assert calls == [norm.BN_EPS] * 16   # two chunks, 8 sites each
    want = jax_trainer.generate_batched(u8, chunk=2)
    assert got.shape == want.shape == (3, 32, 32, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5)
    # per image, not per batch: the batch's statistics give another output
    with torch.no_grad():
        x = (torch.from_numpy(u8).float() / 127.5 - 1.0)
        batched = trainer.gen(x, compute_dtype=torch.float32).numpy()
    assert np.abs(batched - got).max() > 1e-3


def test_networks_transplant_round_trip():
    """The {"gen", "disc"} tree: batch norm's gamma and beta pass as they are,
    kernels change layout, and the way back restores every leaf."""
    _, params = _jax_trainer(seed=2)
    trainer = Pix2PixTrainer(_cfg())
    state = networks_to_state_dicts(params)
    assert sorted(state) == ["disc", "gen"]
    trainer.load_state({"params": state})
    np.testing.assert_array_equal(trainer.gen.down_1.norm.beta.detach().numpy(),
                                  params["gen"]["down_1"]["norm"]["beta"])
    assert trainer.disc.down_0.conv.shape == (64, 2, 4, 4)   # the conditional stem
    for name in NETWORKS:
        back = state_dict_to_params(trainer.nets[name].state_dict())
        flat_a = jax.tree_util.tree_leaves_with_path(params[name])
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (_, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("channels", [1, 3])
def test_ssim_and_losses_match_gan_tpu(channels):
    """fp32: the same separable Gaussian sums in other orders (SSIM 1e-5
    relative; the losses 1e-5 relative)."""
    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, (2, 32, 32, channels)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    logits = (3 * rng.standard_normal((2, 2, 2, 1))).astype(np.float32)
    ja, jb, jl = (jnp.asarray(v) for v in (a, b, logits))
    ta, tb, tl = (torch.from_numpy(v) for v in (a, b, logits))
    assert losses.PIX2PIX_LOSS_KEYS == jax_losses.PIX2PIX_LOSS_KEYS
    np.testing.assert_allclose(ssim.ssim(ta, tb, max_val=2.0).numpy(),
                               np.asarray(jax_ssim.ssim(ja, jb, max_val=2.0)), rtol=1e-5)
    pairs = [(ssim.ssim_loss(ta, tb), jax_ssim.ssim_loss(ja, jb))]
    for kind in ("l1", "ssim"):
        pairs.append((losses.pix2pix_secondary_loss(ta, tb, kind),
                      jax_losses.pix2pix_secondary_loss(ja, jb, kind)))
        pairs += zip(losses.pix2pix_generator_loss(tl, ta, tb, lam=100.0, kind=kind),
                     jax_losses.pix2pix_generator_loss(jl, ja, jb, lam=100.0, kind=kind))
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_paired_jitter_matches_gan_tpu():
    """The same (oh, ow, flip) into both: one crop and one mirror per pair,
    selected exactly."""
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (4, 2, 62, 62, 3), dtype=np.uint8)
    oh, ow = rng.integers(0, 31, 4), rng.integers(0, 31, 4)
    flip = np.array([True, False, False, True])
    rows, cols = jax_augment._selectors(jnp.asarray(oh), jnp.asarray(ow), jnp.asarray(flip),
                                        src=62, size=32, dtype=jnp.float32)
    want = np.asarray(jax_augment._crop_matmul(jnp.asarray(u8), rows, cols, jnp.float32))
    draws = tuple(torch.from_numpy(v) for v in (oh, ow, flip))
    got = paired_jitter_batch(torch.from_numpy(u8), None, img_size=32, draws=draws)
    for k in (0, 1):
        assert got[k].is_contiguous() and got[k].shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(got[k].numpy(), want[:, k])
    # drawn: repeatable, and input and target share their crop and mirror
    same = torch.from_numpy(np.repeat(u8[:, :1], 2, axis=1))
    a = paired_jitter_batch(same, torch.Generator().manual_seed(1), img_size=32)
    b = paired_jitter_batch(same, torch.Generator().manual_seed(1), img_size=32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a[0], a[1], rtol=0, atol=0)


def test_split_and_caches_match_gan_tpu(tmp_path, monkeypatch):
    names = [f"p{i}.png" for i in range(23)]
    kw = dict(seed=5, test_img=3, validation_size=0.2)
    assert pix2pix_split(names, **kw) == jax_pix2pix_split(names, **kw)
    rng = np.random.default_rng(8)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"p{i}.png"))
        Image.fromarray(rng.integers(0, 255, (40, 70), np.uint8), "L").save(paths[-1])
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")   # gan_tpu's Python path
    for orient in ("left", "right"):
        for train in (True, False):
            kw = dict(img_size=32, channels=1, orient=orient, train=train)
            got = build_pix2pix_cache(paths, **kw)
            assert got.shape == (3, 2, 62 if train else 32, 62 if train else 32, 1)
            np.testing.assert_array_equal(got, jax_pipeline.build_pix2pix_cache(paths, **kw))


_PARITY_ARGV = [
    [],
    ["--channels", "3", "--dtype", "fp32", "--seed", "7", "--lambda", "5", "--batch-size", "4",
     "--generator-loss", "ssim", "--input-img-orient", "right", "--use-pallas", "off",
     "--raw-predictions", "true", "--num-devices", "2", "--remat", "on", "--host-cache", "off",
     "--device-cache", "on", "--bn-cross-replica", "true", "--checkpoint-every", "2",
     "--resume", "r", "--test-img", "3", "--validation-size", "0.2", "--learning-rate", "1e-3",
     "--beta-1", "0.9", "--beta-2", "0.99", "--epochs", "9", "--buffer-size", "10",
     "--logging", "false", "--save-weights", "false", "--img-size", "512"],
]


@pytest.mark.parametrize("extra", _PARITY_ARGV, ids=["defaults", "every_flag"])
def test_config_matches_gan_tpu(extra):
    """The same fields and defaults, and config.json byte for byte."""
    assert ([(f.name, f.default) for f in dataclasses.fields(Pix2PixConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jax_config.Pix2PixConfig)])
    argv = ["--data", "d", "--output", "o", "--predict", "--weights", "w", *extra]
    assert parse_pix2pix(argv).to_json() == jax_config.parse_pix2pix(argv).to_json()
    for bad in (["--generator-loss", "l2"], ["--input-img-orient", "up"], ["--channels", "2"]):
        for parse in (parse_pix2pix, jax_config.parse_pix2pix):
            with pytest.raises(SystemExit):
                parse(argv + bad)


def _leaves(tree):
    return [np.asarray(a) for _, a in jax.tree_util.tree_leaves_with_path(tree)]


def _two_pass_batch_norm(x, gamma, beta, *, eps=jax_norm.BN_EPS, axis_name=None):
    """gan_tpu's batch_norm with the variance taken as E[(x − mean)²]."""
    assert axis_name is None
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=(0, 1, 2))
    var = jnp.mean(jnp.square(xf - mean), axis=(0, 1, 2))
    inv = jax.lax.rsqrt(var + eps) * gamma.astype(jnp.float32)
    return (xf * inv + (beta.astype(jnp.float32) - mean * inv)).astype(x.dtype)


@pytest.mark.parametrize("generator_loss", ["l1", "ssim"])
def test_pix2pix_train_steps_match_gan_tpu(monkeypatch, generator_loss):
    """Three full steps (generator, discriminator, two Adams) against
    gan_tpu's fused, stop-gradient-partitioned ``_train_step`` on
    transplanted weights, fp32, dropout rate 0; before each, both networks'
    gradients against ``jax.grad`` of gan_tpu's combined loss. Each step
    starts from gan_tpu's parameters after the last one; the Adams carry
    their own moments.

    gan_tpu's batch norm takes the variance as E[x²] − mean², which cancels
    where a channel's few values lie close together (the 1×1 bottleneck holds
    2 values per channel at batch 2): at the second step here it put
    gan_tpu's gradients 7.6e-4 (gen) and 9.8e-3 (disc) from a float64 run of
    the port, which the fp32 port met within 1.5e-5. So gan_tpu's blocks get
    the two-pass variance here, as they get a zero dropout rate, and the
    tolerances measure the step; test_batch_norm_matches_gan_tpu holds the
    norm to gan_tpu's own formula.

    Tolerances, for fp32 sums in other orders through a U-Net and two
    PatchGAN passes with batch statistics: losses 1e-5 relative. Gradients:
    relative L2 error 1e-4 per network at each step (seen at most 2.9e-5;
    each package within 2.6e-5 of the port in float64). Parameters: Adam's first update lr·g/(|g| + 1e-7)
    turns gradient noise into up to a sign flip, so atol 1e-5 wherever every
    gradient so far agreed within 2% of itself, and 2·lr elsewhere."""
    monkeypatch.setattr(jax_blocks, "batch_norm", _two_pass_batch_norm)
    monkeypatch.setattr(jax_blocks, "DROP_RATE", 0.0)
    jax_trainer, params = _jax_trainer(generator_loss, seed=9)
    opt_states = {"gen": jax_trainer.tx_gen.init(params["gen"]),
                  "disc": jax_trainer.tx_disc.init(params["disc"])}
    trainer = Pix2PixTrainer(_cfg("--generator-loss", generator_loss))
    trainer.load_state({"params": networks_to_state_dicts(params)})
    rng = np.random.default_rng(10)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(0)   # feeds only zero-rate dropout
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    step = jax.jit(lambda p, o: (jax.grad(jax_trainer._losses, has_aux=True)(p, jx, jy, key)[0],
                                 jax_trainer._train_step(p, o, (jx, jy), key)))
    lr = jax_trainer.config.learning_rate
    agreed = {name: [np.ones(a.shape, bool) for a in _leaves(params[name])] for name in NETWORKS}
    for s in range(3):
        want_grads, (params, opt_states, want_losses) = step(params, opt_states)
        got_grads, got_losses = trainer.gradients(tx, ty)
        for name in NETWORKS:
            named = dict(zip([k for k, _ in trainer.nets[name].named_parameters()],
                             got_grads[name]))
            want, got = _leaves(want_grads[name]), _leaves(state_dict_to_params(named))
            err = math.sqrt(sum(np.square(g - w).sum() for g, w in zip(got, want)))
            norm_w = math.sqrt(sum(np.square(w).sum() for w in want))
            assert err <= 1e-4 * norm_w, (name, s, err / norm_w)
            for i, (g, w) in enumerate(zip(got, want)):
                agreed[name][i] &= np.abs(g - w) <= 0.02 * np.abs(w)
        trainer.apply_gradients(got_grads)
        np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=1e-5,
                                   err_msg=f"losses, step {s}")
        for name in NETWORKS:
            back = state_dict_to_params(trainer.nets[name].state_dict())
            for i, (w, g) in enumerate(zip(_leaves(params[name]), _leaves(back))):
                d = np.abs(g - w)
                assert d[agreed[name][i]].max(initial=0) <= 1e-5, (name, i, s)
                assert d.max() <= 2 * lr, (name, i, s)
        trainer.load_state({"params": networks_to_state_dicts(params)})


def test_step_runs_the_derived_stem_and_norm_counts(monkeypatch):
    """What chip_smoke.py counts as launches on the card: 3 stems per train
    and per val step (G once, D on the real and the fake pair) and no
    per-image norm; per predict chunk one stem and one per-image norm per
    site (8 at depth 5, 14 at depth 8)."""
    trainer = Pix2PixTrainer(_cfg())
    counts = {"stem": 0, "per_image": 0}
    real_stem, real_in = blocks.stem_conv, blocks.instance_norm
    monkeypatch.setattr(blocks, "stem_conv", lambda *a, **kw: counts.__setitem__(
        "stem", counts["stem"] + 1) or real_stem(*a, **kw))
    monkeypatch.setattr(blocks, "instance_norm", lambda *a, **kw: counts.__setitem__(
        "per_image", counts["per_image"] + 1) or real_in(*a, **kw))
    u8 = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (3, 2, 62, 62, 1),
                                                              dtype=np.uint8))
    out = trainer.run_epoch(u8, 0, training=True)   # a full step and the 1-row remainder
    assert out.shape == (2, 4) and np.isfinite(out).all()
    # the 1-row remainder normalises per image: the U-Net's 8 sites and 3 per PatchGAN pass
    assert counts == {"stem": 2 * chip_smoke.PIX2PIX_STEMS_PER_STEP, "per_image": 8 + 2 * 3}
    counts.update(stem=0, per_image=0)
    trainer.run_epoch(u8[:2, :, :32, :32], 0, training=False)
    assert counts == {"stem": chip_smoke.PIX2PIX_STEMS_PER_STEP, "per_image": 0}
    counts.update(stem=0, per_image=0)
    trainer.generate_batched(u8[:3, 0, :32, :32].numpy(), chunk=2)
    assert counts == {"stem": 2, "per_image": 2 * len(chip_smoke.norm_sites(32, 5))}


def test_cli_train_and_predict_write_gan_tpu_output_tree(tmp_path):
    """``python -m gan_tpu_torch.pix2pix --train`` at 32², 2 epochs, then
    ``--predict --weights`` on its run: gan_tpu's pix2pix.py tree,
    config.json and loss keys."""
    rng = np.random.default_rng(12)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(9):
        Image.fromarray(rng.integers(0, 255, (40, 72), np.uint8), "L").save(data / f"p{i}.png")
    out = tmp_path / "out"
    common = ["--data", str(data), "--img-size", "32", "--dtype", "fp32", "--logging", "false"]
    argv = [*common, "--output", str(out), "--train", "--epochs", "2", "--batch-size", "2",
            "--test-img", "2", "--validation-size", "0.3"]
    proc = subprocess.run([sys.executable, "-m", "gan_tpu_torch.pix2pix", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Val generator loss" in proc.stdout
    (run,) = glob.glob(str(out / "*"))
    with open(os.path.join(run, "logs", "config.json")) as f:
        assert f.read() == jax_config.parse_pix2pix(argv).to_json()
    for name in ("train_metrics.json", "val_metrics.json"):
        with open(os.path.join(run, "logs", name)) as f:
            metrics = json.load(f)
        assert tuple(metrics) == jax_losses.PIX2PIX_LOSS_KEYS
        assert all(len(v) == 2 and all(math.isfinite(e) for e in v) for v in metrics.values())
    figs = sorted(os.listdir(os.path.join(run, "figs")))
    assert figs == sorted(f"Pix2Pix {k}.png" for k in jax_losses.PIX2PIX_LOSS_KEYS)
    assert sorted(os.listdir(os.path.join(run, "final_test_imgs"))) == ["img0.png", "img1.png"]
    assert os.listdir(os.path.join(run, "training_checkpoints")) == ["2"]
    assert os.path.isdir(os.path.join(run, "test_images"))

    pred = tmp_path / "pred"
    proc = subprocess.run([sys.executable, "-m", "gan_tpu_torch.pix2pix", *common,
                           "--output", str(pred), "--predict", "--weights", run],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (pred_run,) = glob.glob(str(pred / "*"))
    names = sorted(os.listdir(os.path.join(pred_run, "prediction_images")))
    assert names == sorted(f"img{i}.png" for i in range(9))
