"""gan_tpu checkpoints carried into the port (tools/convert_gan_tpu_checkpoint.py
and gan_tpu_torch/transplant.py's Adam mapping) on the CPU, for Pix2Pix and
CycleGAN at 32² (depth 5, no dropout block), fp32: gan_tpu takes two train
steps and saves through orbax; the converter writes the port's checkpoint;
then the converted state against gan_tpu's, the port's ``--predict`` PNGs
against gan_tpu's, the port's next train step against gan_tpu's next step on
the same batch, and ``--resume`` from the converted epoch. Also a bare
orbax directory as tools/import_tf_checkpoint.py writes it, and the port's
refusal of an orbax directory. Inputs come from numpy seeds; each tolerance
is stated beside its assertion."""

import glob
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gan_tpu.models.blocks as jax_blocks
from gan_tpu import config as jax_config
from gan_tpu.parallel.mesh import make_mesh
from gan_tpu.train.checkpoint import CheckpointManager as OrbaxManager
from gan_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxCycleGAN
from gan_tpu.train.pix2pix_trainer import Pix2PixTrainer as JaxPix2Pix

from gan_tpu_torch import cycle_gan as port_cycle_gan
from gan_tpu_torch import pix2pix as port_pix2pix
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
from gan_tpu_torch.transplant import _TO_TORCH, state_dict_to_params
from test_torch_pix2pix import _two_pass_batch_norm
from torch_inputs import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 3   # the epoch the gan_tpu checkpoint records
SIZE = 32


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


converter = _load_by_path("convert_gan_tpu_checkpoint", "tools/convert_gan_tpu_checkpoint.py")

# per model: gan_tpu's CLI module, the port's CLI, both parsers and trainers,
# the keys of non-zero shifts (at init they are 0), the step's gradient tolerance
MODELS = {
    "pix2pix": dict(cli="pix2pix.py", port=port_pix2pix, jax_parse=jax_config.parse_pix2pix,
                    parse=parse_pix2pix, jax_trainer=JaxPix2Pix, trainer=Pix2PixTrainer,
                    shifts=("beta", "bias"), grad_tol=1e-4),
    "cyclegan": dict(cli="cycle_gan.py", port=port_cycle_gan,
                     jax_parse=jax_config.parse_cyclegan, parse=parse_cyclegan,
                     jax_trainer=JaxCycleGAN, trainer=CycleGANTrainer,
                     shifts=("offset",), grad_tol=1e-2),
}


def _data_argv(kind, root):
    """PNGs under ``root`` and the flags that name them: 6 side-by-side pairs
    for Pix2Pix, 6 X and 5 Y images for CycleGAN."""
    rng = np.random.default_rng(0)
    dirs = {"pix2pix": (("data", 6, (40, 72)),),
            "cyclegan": (("x", 6, (40, 36)), ("y", 5, (36, 40)))}[kind]
    for d, n, shape in dirs:
        os.makedirs(root / d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, shape, np.uint8), "L").save(root / d / f"{d}{i}.png")
    if kind == "pix2pix":
        return ["--data", str(root / "data")], []
    return ["--input-images", str(root / "x")], ["--target-images", str(root / "y")]


def _common(*extra):
    return ["--img-size", str(SIZE), "--dtype", "fp32", "--logging", "false", *extra]


def _leaves(tree):
    return [np.asarray(a) for _, a in jax.tree_util.tree_leaves_with_path(tree)]


def _convert(kind, root):
    """gan_tpu's trainer after two train steps on a seeded batch (the
    two-pass batch norm, as in ``_check_next_step``), saved at epoch EPOCH
    through orbax into a run dir with its config.json, and that run
    converted into the port's checkpoint."""
    m = MODELS[kind]
    inputs, targets = _data_argv(kind, root)
    run, out = root / "run", root / "converted"
    cfg = m["jax_parse"]([*inputs, *targets, "--output", str(root), "--train", "--epochs",
                          str(EPOCH), "--batch-size", "2", "--num-devices", "1", *_common()])
    jt = m["jax_trainer"](cfg, mesh=make_mesh(1))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key in m["shifts"] else np.asarray(a), jax.device_get(jt.params))
    jt.load_state({"params": params, "opt_states": jt.opt_states})   # placed as the step's outputs
    x, y = (rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32) for _ in range(2))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    key = jax.random.PRNGKey(0)   # feeds no draw at depth 5
    # each step's gradients and the step itself, traced with the two-pass
    # batch norm of tests/test_torch_pix2pix.py's step test
    step = jax.jit(lambda p, o: (jax.grad(jt._losses, has_aux=True)(p, jx, jy, key)[0],
                                 jt._train_step(p, o, (jx, jy), key)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks, "batch_norm", _two_pass_batch_norm)
        for _ in range(2):
            _, (jt.params, jt.opt_states, _) = step(jt.params, jt.opt_states)
    os.makedirs(run / "logs")
    cfg.dump(str(run / "logs" / "config.json"))
    mgr = OrbaxManager(str(run / "training_checkpoints"))
    mgr.save(EPOCH, jt.state())
    mgr.close()
    assert converter.main([str(run), "--output", str(out)]) == 0
    return dict(kind=kind, root=root, inputs=inputs, targets=targets, run=run, out=out,
                jax_trainer=jt, state=jax.device_get(jt.state()), x=x, y=y, step=step)


@pytest.mark.parametrize("kind", list(MODELS))
def test_gan_tpu_checkpoint_carries_into_the_port(kind, tmp_path, monkeypatch, capsys):
    """One test per model, so that a parallel run converts each model once."""
    c = _convert(kind, tmp_path)
    _check_state(c)
    _check_predict(c, tmp_path / "predict", monkeypatch)
    _check_next_step(c, monkeypatch)
    _check_resume(c, tmp_path / "resume", capsys)


def _port_trainer(c, *extra):
    m = MODELS[c["kind"]]
    return m["trainer"](m["parse"]([*c["inputs"], *c["targets"], "--output", "o", "--train",
                                    "--epochs", "1", "--batch-size", "2", *_common(*extra)]))


def _check_state(c):
    """Bit for bit: every parameter and Adam moment through its permute,
    each Adam's step = optax's count = 2, the port's own param_groups, and the
    epoch."""
    mgr = CheckpointManager(latest_checkpoint_dir(str(c["out"])))
    assert mgr.all_epochs() == [EPOCH]
    state = mgr.restore()
    fresh = _port_trainer(c)
    assert set(state["params"]) == set(c["state"]["params"]) == set(fresh.nets)
    for name, net in fresh.nets.items():
        back = state_dict_to_params(state["params"][name])
        for want, got in zip(_leaves(c["state"]["params"][name]), _leaves(back)):
            np.testing.assert_array_equal(got, want)
        adam, opt = c["state"]["opt_states"][name][0], state["opt_states"][name]
        assert int(adam.count) == 2
        assert opt["param_groups"] == fresh.opts[name].state_dict()["param_groups"]
        named = [k for k, _ in net.named_parameters()]
        assert sorted(opt["state"]) == list(range(len(named)))
        for moment, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            flat = jax.tree_util.tree_leaves_with_path(moment)
            assert sorted(".".join(p.key for p in path) for path, _ in flat) == sorted(named)
            for path, a in flat:
                a = np.asarray(a)
                got = opt["state"][named.index(".".join(p.key for p in path))][key].numpy()
                np.testing.assert_array_equal(got, a.transpose(_TO_TORCH) if a.ndim == 4 else a)
        assert all(s["step"].item() == 2.0 for s in opt["state"].values())


def _check_predict(c, tmp_path, monkeypatch):
    """The port's ``--predict --weights`` on the converted checkpoint against
    gan_tpu's ``--predict`` on the orbax run: the bare predictions
    (``--raw-predictions``) and the prediction grids, within 1 per uint8
    pixel (fp32 on both sides, sums in other orders, seen 2e-5 before the
    rounding to uint8)."""
    m = MODELS[c["kind"]]
    monkeypatch.setenv("GAN_TPU_PALLAS", "auto")   # gan_tpu's CLI writes it
    jax_cli = _load_by_path(f"gan_tpu_{c['kind']}_cli", m["cli"])
    argv = [*c["inputs"], "--predict", "--raw-predictions", "true", *_common()]
    jax_cli.main(m["jax_parse"]([*argv, "--output", str(tmp_path / "jax"), "--weights",
                                 str(c["run"]), "--num-devices", "1"]))
    m["port"].main(m["parse"]([*argv, "--output", str(tmp_path / "port"), "--weights",
                               str(c["out"])]))
    (jax_run,), (port_run,) = (glob.glob(str(tmp_path / d / "*")) for d in ("jax", "port"))
    for sub in ("prediction_images", "prediction_images_raw"):
        names = sorted(os.listdir(os.path.join(jax_run, sub)))
        assert len(names) == 6 and names == sorted(os.listdir(os.path.join(port_run, sub)))
        for n in names:
            a, b = (np.asarray(Image.open(os.path.join(r, sub, n)), np.int16)
                    for r in (jax_run, port_run))
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, (sub, n)


def _check_next_step(c, monkeypatch):
    """The port's train step from the converted state against gan_tpu's
    third step from its saved state, on the batch of the first two (no draws
    at depth 5):
    losses, each network's gradients, parameters, and the Adam moments and
    step (3), so the bias correction runs at a step count other than 1.
    gan_tpu's batch norm gets the two-pass variance, as in
    tests/test_torch_pix2pix.py's step test.

    Tolerances, those of the step tests: losses 1e-5 relative (Pix2Pix) and
    1e-4 (CycleGAN); gradients a relative L2 error of 1e-4 (Pix2Pix) and 1e-2
    (CycleGAN) per network. Parameters: atol 1e-5 wherever the gradient agreed
    within 2% of itself, and 2·lr elsewhere (Adam's sign noise). The moments
    start equal, so exp_avg differs by (1 − β1)·(g − g') and exp_avg_sq by
    (1 − β2)·(g² − g'²): exp_avg within (1 − β1) times the gradient
    tolerance of ‖g‖ in L2, exp_avg_sq within the gradient tolerance of
    itself in L2."""
    m = MODELS[c["kind"]]
    monkeypatch.setattr(jax_blocks, "batch_norm", _two_pass_batch_norm)   # were it traced anew
    jt, state = c["jax_trainer"], c["state"]
    want_grads, (params, opt_states, want_losses) = c["step"](jt.params, jt.opt_states)

    trainer = _port_trainer(c)
    trainer.load_state(CheckpointManager(latest_checkpoint_dir(str(c["out"]))).restore())
    got_grads, got_losses = trainer.gradients(torch.from_numpy(c["x"]), torch.from_numpy(c["y"]))
    trainer.apply_gradients(got_grads)
    loss_tol = 1e-5 if c["kind"] == "pix2pix" else 1e-4
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(want_losses), rtol=loss_tol)
    lr, b1, tol = jt.config.learning_rate, jt.config.beta_1, m["grad_tol"]
    for name, net in trainer.nets.items():
        named = [k for k, _ in net.named_parameters()]
        to_jax = lambda ts: _leaves(state_dict_to_params(dict(zip(named, ts))))
        want, got = _leaves(want_grads[name]), to_jax(got_grads[name])
        g_norm = math.sqrt(sum(np.square(w).sum() for w in want))
        err = math.sqrt(sum(np.square(g - w).sum() for g, w in zip(got, want)))
        assert err <= tol * g_norm, (name, err / g_norm)
        agreed = [np.abs(g - w) <= 0.02 * np.abs(w) for g, w in zip(got, want)]
        back = _leaves(state_dict_to_params(net.state_dict()))
        for i, (w, g) in enumerate(zip(_leaves(params[name]), back)):
            d = np.abs(g - w)
            assert d[agreed[i]].max(initial=0) <= 1e-5, (name, i)
            assert d.max() <= 2 * lr, (name, i)
        opt = trainer.opts[name].state_dict()["state"]
        adam = opt_states[name][0]
        assert int(adam.count) == 3
        assert all(s["step"].item() == 3.0 for s in opt.values())
        for moment, key_, bound in ((adam.mu, "exp_avg", (1 - b1) * tol * g_norm),
                                    (adam.nu, "exp_avg_sq", None)):
            w, g = _leaves(moment), to_jax([opt[i][key_] for i in range(len(named))])
            diff = math.sqrt(sum(np.square(a - b).sum() for a, b in zip(g, w)))
            ref = math.sqrt(sum(np.square(a).sum() for a in w))
            assert diff <= (bound if bound is not None else tol * ref), (name, key_, diff)


def _check_resume(c, tmp_path, capsys):
    """``--train --resume OUT`` restores the converted state and trains the
    epochs after EPOCH: one here, saved as epoch EPOCH + 1."""
    m = MODELS[c["kind"]]
    argv = [*c["inputs"], *c["targets"], "--output", str(tmp_path), "--train", "--epochs",
            str(EPOCH + 1), "--batch-size", "2", "--test-img", "1", "--validation-size", "0.3",
            "--resume", str(c["out"]), *_common()]
    m["port"].main(m["parse"](argv))
    assert f"Resumed from {c['out']} at epoch {EPOCH}" in capsys.readouterr().out
    (run,) = glob.glob(str(tmp_path / "*"))
    assert os.listdir(os.path.join(run, "training_checkpoints")) == [str(EPOCH + 1)]
    with open(os.path.join(run, "logs", "train_metrics.json")) as f:
        metrics = json.load(f)
    assert all(len(v) == 1 and math.isfinite(v[0]) for v in metrics.values())


def test_orbax_directory_is_refused(tmp_path):
    """An epoch directory laid out like orbax's (no state.pt) makes the
    port's checkpoint manager raise and name the converter, in --predict as
    in --resume; the converter wants --model where a run has no config."""
    ckpt = tmp_path / "run" / "training_checkpoints"
    os.makedirs(ckpt / "5" / "default")
    (ckpt / "5" / "_CHECKPOINT_METADATA").write_text("{}")
    mgr = CheckpointManager(latest_checkpoint_dir(str(tmp_path / "run")))
    for call in (mgr.all_epochs, mgr.latest_epoch, mgr.restore):
        with pytest.raises(ValueError, match="tools/convert_gan_tpu_checkpoint.py"):
            call()
    os.makedirs(tmp_path / "x")
    Image.fromarray(np.zeros((32, 32), np.uint8), "L").save(tmp_path / "x" / "a.png")
    cfg = parse_cyclegan(["--input-images", str(tmp_path / "x"), "--output", str(tmp_path / "o"),
                          "--predict", "--weights", str(tmp_path / "run"), *_common()])
    with pytest.raises(ValueError, match="convert_gan_tpu_checkpoint"):
        port_cycle_gan.main(cfg)
    with pytest.raises(SystemExit, match="give --model"):
        converter.main([str(tmp_path / "run"), "--output", str(tmp_path / "out")])


def test_imported_tf_layout_converts_with_adam_at_step_0(tmp_path):
    """The second step of the TF-reference route: a bare orbax directory as
    tools/import_tf_checkpoint.py saves it (params only, fresh Adam, no
    config.json), converted with --model, --img-size and --channels. The
    first step needs tensorflow and a reference checkout, and is not run."""
    import_tf = _load_by_path("import_tf_checkpoint", "tools/import_tf_checkpoint.py")
    cfg = jax_config.parse_pix2pix(["--data", "d", "--output", "o", "--train", "--epochs", "1",
                                    "--num-devices", "1", *_common()])
    params = jax.device_get(JaxPix2Pix(cfg, mesh=make_mesh(1)).params)
    import_tf.save_as_gan_tpu(params, "pix2pix", str(tmp_path / "imported"), SIZE, "1", epoch=7)
    assert converter.main([str(tmp_path / "imported"), "--output", str(tmp_path / "out"),
                           "--model", "pix2pix", "--img-size", str(SIZE), "--channels", "1"]) == 0
    mgr = CheckpointManager(latest_checkpoint_dir(str(tmp_path / "out")))
    assert mgr.all_epochs() == [7]
    state = mgr.restore()
    for name in ("gen", "disc"):
        back = state_dict_to_params(state["params"][name])
        for want, got in zip(_leaves(params[name]), _leaves(back)):
            np.testing.assert_array_equal(got, want)
        opt = state["opt_states"][name]["state"]
        assert all(s["step"].item() == 0.0 and not s["exp_avg"].any() and not s["exp_avg_sq"].any()
                   for s in opt.values())
