"""The port's CycleGAN training slice against gan_tpu's on the CPU: K2's plain
version, the PatchGAN, the losses, Adam, the jitter, the split and shuffles,
three full train steps on transplanted weights, the step's norm counts, the
training state's round trip, and the ``--train`` CLI. Inputs come from numpy
seeds; each tolerance is stated beside its assertion. At 32² the U-Net has
depth 5 and no dropout block."""

import glob
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
from gan_tpu.data.split import cyclegan_split as jax_cyclegan_split
from gan_tpu.models import PatchGANDiscriminator as JaxPatchGAN
from gan_tpu.ops import loss_ops as jax_loss_ops
from gan_tpu.ops import pallas_kernels
from gan_tpu.parallel.mesh import make_mesh
from gan_tpu.train import loop as jax_loop
from gan_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxTrainer
from gan_tpu.train.optim import adam as jax_adam

import chip_smoke
from gan_tpu_torch import losses
from gan_tpu_torch.config import parse_cyclegan
from gan_tpu_torch.data.augment import crop_flip_normalize, single_jitter_batch
from gan_tpu_torch.data.split import cyclegan_split
from gan_tpu_torch.models import PatchGANDiscriminator
from gan_tpu_torch.models.blocks import InstanceNorm
from gan_tpu_torch.ops import kernels, loss_ops, norm
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.cyclegan_trainer import NETWORKS, CycleGANTrainer
from gan_tpu_torch.train.optim import adam
from gan_tpu_torch.transplant import params_to_state_dict, state_dict_to_params
from torch_inputs import norm_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# H·W = 1 (the bottleneck), 961 (the PatchGAN's 31² site), a ragged channel count
_BWD_SHAPES = [(2, 1, 1, 64), (2, 31, 31, 512), (3, 4, 5, 80), (2, 16, 16, 128)]


def _bwd_inputs(shape):
    x, scale, offset = norm_inputs(shape, seed=7)
    dy = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    return x, scale, offset, dy


@pytest.mark.parametrize("shape", _BWD_SHAPES, ids=str)
def test_instance_norm_backward_matches_pallas_vjp(shape):
    """K2's plain version against K2 itself (``_in_backward`` in interpret
    mode, through the custom VJP). K2 takes its variance as E[x²]−mean², which
    loses a few ulps at |mean| ~ 1, var ~ 9 (the forward's test allows 1e-4 on
    x̂): 1e-4 on dx, and on the sums over N·H·W ≤ 1,922 terms 1e-3."""
    x, scale, offset, dy = _bwd_inputs(shape)
    _, vjp = jax.vjp(pallas_kernels.instance_norm, jnp.asarray(x), jnp.asarray(scale),
                     jnp.asarray(offset))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = [g.numpy() for g in kernels.instance_norm_backward(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(dy))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", _BWD_SHAPES, ids=str)
def test_instance_norm_backward_matches_autograd(shape, dtype):
    """The explicit formula against torch's autograd of the plain forward.
    fp32: the same statistics, sums in other orders (2e-5 on dx; on the sums
    1e-4 relative). bf16: the same bf16 x and dy, fp32 math; dx's one bf16
    rounding may land one ulp apart (2^-7 relative)."""
    x, scale, offset, dy = (torch.from_numpy(a) for a in _bwd_inputs(shape))
    x, dy = x.to(dtype), dy.to(dtype)
    xr, sr, orr = (t.clone().requires_grad_() for t in (x, scale, offset))
    want = torch.autograd.grad(norm.instance_norm(xr, sr, orr), (xr, sr, orr), dy)
    got = norm.instance_norm_backward(x, scale, dy)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    dx_tol = dict(atol=2e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=1e-3, rtol=2 ** -7)
    torch.testing.assert_close(got[0].float(), want[0].float(), **dx_tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _jax_patchgan(seed=0, in_channels=1):
    disc = JaxPatchGAN(norm="instance", target=False)
    params = disc.init(jax.random.PRNGKey(seed), in_channels)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key in ("offset", "bias") else a, params)
    return disc, params


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_patchgan_matches_gan_tpu(dtype):
    jax_disc, params = _jax_patchgan()
    disc = PatchGANDiscriminator(1)
    disc.load_state_dict(params_to_state_dict(params))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    jdt, tdt = (None, None) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax.jit(lambda p, v: jax_disc.apply(p, v, compute_dtype=jdt))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = disc(torch.from_numpy(x), compute_dtype=tdt).numpy()
    assert got.shape == want.shape == (2, 6, 6, 1) and got.dtype == np.float32
    # fp32: 5 convs and 3 norms of fp32 sums in different orders. bf16: each
    # framework rounds to bf16 at its own points; 3 renormalizing layers
    atol = 2e-5 if dtype == "fp32" else 0.05
    np.testing.assert_allclose(got, want, atol=atol)


def test_patchgan_transplant_round_trip():
    _, params = _jax_patchgan(seed=1)
    disc = PatchGANDiscriminator(1)
    disc.load_state_dict(params_to_state_dict(params))
    back = state_dict_to_params(disc.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert disc.conv512.shape == (512, 256, 4, 4) and disc.last.conv.shape == (1, 512, 4, 4)


def test_patchgan_batch_norm_is_not_ported():
    with pytest.raises(NotImplementedError):
        PatchGANDiscriminator(1, norm="batch")


def test_losses_match_gan_tpu():
    """fp32 means of the same elementwise formulas: 1e-6 relative."""
    rng = np.random.default_rng(9)
    a, b = (rng.standard_normal((2, 6, 6, 1)).astype(np.float32) * 3 for _ in range(2))
    labels = (rng.random((2, 6, 6, 1)) > 0.5).astype(np.float32)
    ja, jb, jl = (jnp.asarray(v) for v in (a, b, labels))
    ta, tb, tl = (torch.from_numpy(v) for v in (a, b, labels))
    assert losses.CYCLEGAN_LOSS_KEYS == jax_losses.CYCLEGAN_LOSS_KEYS
    assert losses.empty_losses(losses.CYCLEGAN_LOSS_KEYS) == \
        jax_losses.empty_losses(jax_losses.CYCLEGAN_LOSS_KEYS)
    pairs = [
        (loss_ops.bce_with_logits(tl, ta), jax_loss_ops.bce_with_logits(jl, ja)),
        (loss_ops.l1_loss(ta, tb), jax_loss_ops.l1_loss(ja, jb)),
        (losses.discriminator_loss(ta, tb, 0.5), jax_losses.discriminator_loss(ja, jb, 0.5)),
        (losses.generator_adversarial_loss(ta), jax_losses.generator_adversarial_loss(ja)),
        (losses.cycle_loss(ta, tb, 10.0), jax_losses.cycle_loss(ja, jb, 10.0)),
        (losses.identity_loss(ta, tb, 10.0), jax_losses.identity_loss(ja, jb, 10.0)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_adam_matches_optax():
    """Three updates against gan_tpu's optax Adam (eps 1e-7, eps_root 0):
    the same fp32 formula, the bias corrections in another order (1e-6)."""
    rng = np.random.default_rng(10)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 10.0 ** -s
              for k, v in p0.items()} for s in range(3)]
    tx = jax_adam(2e-4, 0.5, 0.999)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = adam(list(tp.values()), 2e-4, 0.5, 0.999)
    for g in grads:
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = {k: jp[k] + up[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)


def test_single_jitter_matches_gan_tpu():
    """The same (oh, ow, flip) into both: the crop selects exactly."""
    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (4, 62, 62, 3), dtype=np.uint8)
    oh, ow = rng.integers(0, 31, 4), rng.integers(0, 31, 4)
    flip = np.array([True, False, True, False])
    rows, cols = jax_augment._selectors(jnp.asarray(oh), jnp.asarray(ow), jnp.asarray(flip),
                                        src=62, size=32, dtype=jnp.float32)
    want = np.asarray(jax_augment._crop_matmul(jnp.asarray(u8), rows, cols, jnp.float32))
    got = crop_flip_normalize(torch.from_numpy(u8), torch.from_numpy(oh), torch.from_numpy(ow),
                              torch.from_numpy(flip), img_size=32)
    np.testing.assert_array_equal(got.numpy(), want)
    # the draws: offsets in [0, 30], one mirror gate per image, repeatable
    a = single_jitter_batch(torch.from_numpy(u8), torch.Generator().manual_seed(1), img_size=32)
    b = single_jitter_batch(torch.from_numpy(u8), torch.Generator().manual_seed(1), img_size=32)
    assert a.shape == (4, 32, 32, 3) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cyclegan_split_matches_gan_tpu():
    xs = [f"x{i}.png" for i in range(23)]
    ys = [f"y{i}.jpg" for i in range(17)]
    kw = dict(seed=5, test_img=3, validation_size=0.2)
    assert cyclegan_split(xs, ys, **kw) == jax_cyclegan_split(xs, ys, **kw)


@pytest.mark.parametrize("buffer_size", [1, 4, 99999])
def test_epoch_perm_matches_gan_tpu(buffer_size):
    """The windowed shuffle (buffer < n) too: the same draws from the same
    epoch_rng, a permutation, and no row drawn more than buffer − 1 places
    ahead of its stream position."""
    n = 23
    got = loop.epoch_perm(n, buffer_size, loop.epoch_rng(3, 2, 1))
    want = jax_loop.epoch_perm(n, buffer_size, jax_loop.epoch_rng(3, 2, 1))
    np.testing.assert_array_equal(got, want)
    assert sorted(got) == list(range(n))
    assert all(got[i] <= i + buffer_size - 1 for i in range(n))
    for m, b in [(9, 4), (8, 4), (3, 8)]:
        assert loop.epoch_plan(m, b) == jax_loop.epoch_plan(m, b, 1)[::2]


def _cfg(*extra):
    return parse_cyclegan(["--input-images", "x", "--target-images", "y", "--output", "o",
                           "--train", "--epochs", "1", "--img-size", "32", "--batch-size", "2",
                           "--dtype", "fp32", *extra])


def _xy(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, size, size, 1)).astype(np.float32) for _ in range(2)]


def _leaves(tree):
    return [np.asarray(a) for _, a in jax.tree_util.tree_leaves_with_path(tree)]


def test_cyclegan_train_steps_match_gan_tpu(monkeypatch):
    """Three full steps (2 generators, 2 discriminators, 4 Adams) against
    gan_tpu's fused, stop-gradient-partitioned ``_train_step`` on
    transplanted weights, fp32, dropout off; before each, the four networks'
    gradients against ``jax.grad`` of gan_tpu's combined loss. Each step
    starts from gan_tpu's parameters after the last one; the two Adams carry
    their own moments through all three.

    Tolerances, for fp32 sums taken in other orders through 6 U-Nets and 4
    PatchGANs: losses rtol 1e-4 (seen 1e-6). Gradients: relative L2 error
    1e-2 per network (seen 4e-6 at the first two steps; 3e-3 at the third,
    where a LeakyReLU input within fp32 noise of 0 takes the other slope in
    one package, which a float64 run showed to be the only difference).
    Parameters: atol 1e-5 (seen 1e-6) wherever every gradient so far agreed
    within 2% of itself; elsewhere Adam's lr·g/(|g| + 1e-7) turns gradient
    noise into up to a sign flip, so 2·lr (up to 5% of a generator's
    elements at the third step; at the first, 3 elements moved 2.1e-4)."""
    monkeypatch.setattr(jax_blocks, "DROP_RATE", 0.0)
    jcfg = jax_config.CycleGANConfig(input_images="", target_images="", output="", img_size=32,
                                     batch_size=2, train=True, epochs=1, dtype="fp32",
                                     num_devices=1, lam=10)
    jcfg.validate()
    jax_trainer = JaxTrainer(jcfg, mesh=make_mesh(1))
    rng = np.random.default_rng(12)
    params = jax.tree_util.tree_map_with_path(   # non-zero norm offsets, as a trained model has
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key == "offset" else np.asarray(a), jax.device_get(jax_trainer.params))
    opt_states = {k: jax_trainer.tx.init(params[k]) for k in params}

    trainer = CycleGANTrainer(_cfg())
    trainer.load_state({"params": {k: params_to_state_dict(params[k]) for k in NETWORKS}})
    x, y = _xy(13)
    key = jax.random.PRNGKey(0)   # feeds only zero-rate dropout
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    step = jax.jit(lambda p, o: (jax.grad(jax_trainer._losses, has_aux=True)(p, jx, jy, key)[0],
                                 jax_trainer._train_step(p, o, (jx, jy), key)))
    lr = jcfg.learning_rate
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
            assert err <= 1e-2 * norm_w, (name, s, err / norm_w)
            for i, (g, w) in enumerate(zip(got, want)):
                agreed[name][i] &= np.abs(g - w) <= 0.02 * np.abs(w)
        trainer.apply_gradients(got_grads)
        np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=1e-4,
                                   err_msg=f"losses, step {s}")
        for name in NETWORKS:
            back = state_dict_to_params(trainer.nets[name].state_dict())
            for i, (w, g) in enumerate(zip(_leaves(params[name]), _leaves(back))):
                d = np.abs(g - w)
                assert d[agreed[name][i]].max(initial=0) <= 1e-5, (name, i, s)
                assert d.max() <= 2 * lr, (name, i, s)
        trainer.load_state({"params": {k: params_to_state_dict(params[k]) for k in NETWORKS}})


def test_step_runs_the_derived_norm_counts():
    """Every instance norm forward of a step, and every backward through one,
    as chip_smoke.train_step_launches derives them (there K1 and K2 launches):
    at depth 5 a U-Net has 8 norms and a PatchGAN 3."""
    trainer = CycleGANTrainer(_cfg())
    counts = {"fwd": 0, "bwd": 0}

    def on_forward(module, inputs, out):
        counts["fwd"] += 1
        if out.requires_grad:
            out.register_hook(lambda g: counts.__setitem__("bwd", counts["bwd"] + 1))

    for net in trainer.nets.values():
        for m in net.modules():
            if isinstance(m, InstanceNorm):
                m.register_forward_hook(on_forward)
    x, y = _xy(14)
    trainer.gradients(torch.from_numpy(x), torch.from_numpy(y))
    assert (counts["fwd"], counts["bwd"]) == chip_smoke.train_step_launches(8, 3) == (60, 82)
    counts.update(fwd=0, bwd=0)
    trainer.eval_step(torch.from_numpy(x), torch.from_numpy(y))
    assert counts == {"fwd": 60, "bwd": 0}


def test_training_state_round_trip(tmp_path):
    """All four networks and Adams through a checkpoint: equal state, and a
    step from the restored state equals one from the original."""
    a = CycleGANTrainer(_cfg())
    x, y = (torch.from_numpy(v) for v in _xy(15))
    a.train_step(x, y)
    CheckpointManager(str(tmp_path), max_to_keep=3).save(1, a.state())
    b = CycleGANTrainer(_cfg("--seed", "9"))
    b.load_state(CheckpointManager(str(tmp_path)).restore())
    for name in NETWORKS:
        for (ka, va), (kb, vb) in zip(a.nets[name].state_dict().items(),
                                      b.nets[name].state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
        sa, sb = a.opts[name].state_dict(), b.opts[name].state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sa["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb["state"][i][k]), (name, i, k)
    torch.testing.assert_close(a.train_step(x, y), b.train_step(x, y), rtol=0, atol=0)
    for name in NETWORKS:
        for va, vb in zip(a.params[name], b.params[name]):
            assert torch.equal(va, vb)


def test_run_epoch_takes_the_zip_tail():
    """5 X and 7 Y rows at batch 2: two full steps and a tail of 1 X and 2 Y
    rows, as the reference's zip of ceil-batched datasets (3 steps)."""
    trainer = CycleGANTrainer(_cfg())
    rng = np.random.default_rng(16)
    u8x = torch.from_numpy(rng.integers(0, 256, (5, 62, 62, 1), dtype=np.uint8))
    u8y = torch.from_numpy(rng.integers(0, 256, (7, 62, 62, 1), dtype=np.uint8))
    widths = []
    real_step = trainer._step
    trainer._step = lambda ux, uy, *a: widths.append((len(ux), len(uy))) or real_step(ux, uy, *a)
    out = trainer.run_epoch(u8x, u8y, 0, training=True)
    assert widths == [(2, 2), (2, 2), (1, 2)]
    assert out.shape == (3, 7) and np.isfinite(out).all()


def test_cli_train_writes_gan_tpu_output_tree(tmp_path):
    """``python -m gan_tpu_torch.cycle_gan --train`` at 32², 2 epochs: the run
    tree, config.json and loss keys of gan_tpu's cycle_gan.py."""
    rng = np.random.default_rng(17)
    for d, n in (("x", 8), ("y", 7)):
        (tmp_path / d).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (40, 36), np.uint8), "L").save(
                tmp_path / d / f"{d}{i}.png")
    out = tmp_path / "out"
    argv = ["--input-images", str(tmp_path / "x"), "--target-images", str(tmp_path / "y"),
            "--output", str(out), "--train", "--epochs", "2", "--img-size", "32",
            "--batch-size", "2", "--test-img", "2", "--validation-size", "0.2",
            "--dtype", "fp32", "--logging", "false"]
    proc = subprocess.run([sys.executable, "-m", "gan_tpu_torch.cycle_gan", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Val Y->X generator loss" in proc.stdout
    (run,) = glob.glob(str(out / "*"))
    with open(os.path.join(run, "logs", "config.json")) as f:
        assert json.load(f) == json.loads(jax_config.parse_cyclegan(argv).to_json())
    for name in ("train_metrics.json", "val_metrics.json"):
        with open(os.path.join(run, "logs", name)) as f:
            metrics = json.load(f)
        assert tuple(metrics) == jax_losses.CYCLEGAN_LOSS_KEYS
        assert all(len(v) == 2 and all(math.isfinite(e) for e in v) for v in metrics.values())
    figs = sorted(os.listdir(os.path.join(run, "figs")))
    assert figs == sorted(f"CycleGAN {k}.png" for k in jax_losses.CYCLEGAN_LOSS_KEYS)
    assert sorted(os.listdir(os.path.join(run, "final_test_imgs"))) == ["img0.png", "img1.png"]
    assert os.listdir(os.path.join(run, "training_checkpoints")) == ["2"]
    assert os.path.isdir(os.path.join(run, "test_images"))
