"""The port's CycleGAN predict slice on the CPU: a gan_tpu CycleGANTrainer's
generators are transplanted into a port checkpoint, ``python -m
gan_tpu_torch.cycle_gan --predict`` writes gan_tpu's output tree, and the
port's generate_batched matches gan_tpu's generator on the same weights. Also
the flags and the checkpoint manager both modes share."""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gan_tpu import config as jax_config
from gan_tpu.data.augment import normalize_batch as jax_normalize_batch
from gan_tpu.train.cyclegan_trainer import CycleGANTrainer as JaxTrainer
import gan_tpu_torch.models.blocks as port_blocks
from gan_tpu_torch.config import CycleGANConfig, parse_cyclegan
from gan_tpu_torch.cycle_gan import main as port_main
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.transplant import params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IMAGES = 5


def _argv(images, out, weights, *extra):
    return ["--input-images", images, "--output", out, "--predict", "--weights", weights,
            "--img-size", "32", "--logging", "false", "--dtype", "fp32", *extra]


@pytest.fixture(scope="module")
def transplanted_run(tmp_path_factory):
    """PNGs, plus a run dir whose training_checkpoints/5/ holds the port
    checkpoint of a gan_tpu CycleGANTrainer's two generators."""
    root = tmp_path_factory.mktemp("predict")
    images = root / "x"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(N_IMAGES):
        Image.fromarray(rng.integers(0, 255, (48, 40), np.uint8), "L").save(images / f"img_{i}.png")
    cfg = jax_config.parse_cyclegan(_argv(str(images), str(root / "unused"), str(root))
                                    + ["--num-devices", "1"])
    jax_trainer = JaxTrainer(cfg)
    params = jax.device_get(jax_trainer.params)
    state = {"params": {k: params_to_state_dict(params[k]) for k in ("gen_g", "gen_f")}}
    run = root / "run"
    CheckpointManager(str(run / "training_checkpoints"), max_to_keep=3).save(5, state)
    return images, run, jax_trainer


def test_cli_predict_writes_gan_tpu_output_tree(transplanted_run, tmp_path):
    images, run, _ = transplanted_run
    out = tmp_path / "out"
    argv = _argv(str(images), str(out), str(run))
    proc = subprocess.run([sys.executable, "-m", "gan_tpu_torch.cycle_gan", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (run_dir,) = glob.glob(str(out / "*"))
    with open(os.path.join(run_dir, "logs", "config.json")) as f:
        written = json.load(f)
    # the same keys and values gan_tpu's cycle_gan.py writes for these flags
    assert written == json.loads(jax_config.parse_cyclegan(argv).to_json())
    assert "lambda" in written and "lam" not in written
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(run_dir, "prediction_images", "*")))
    assert names == sorted(f"img{i}.png" for i in range(N_IMAGES))


_PARITY_ARGV = [
    [],
    ["--channels", "3", "--dtype", "fp32", "--seed", "7", "--lambda", "5", "--batch-size", "4",
     "--use-pallas", "off", "--raw-predictions", "true", "--num-devices", "2", "--remat", "on",
     "--host-cache", "off", "--device-cache", "on", "--bn-cross-replica", "true",
     "--checkpoint-every", "2", "--resume", "r", "--target-images", "t", "--test-img", "3",
     "--validation-size", "0.2", "--learning-rate", "1e-3", "--beta-1", "0.9", "--beta-2",
     "0.99", "--epochs", "9", "--buffer-size", "10", "--logging", "false",
     "--save-weights", "false", "--img-size", "512"],
]


@pytest.mark.parametrize("extra", _PARITY_ARGV, ids=["defaults", "every_flag"])
def test_config_matches_gan_tpu(extra):
    """The port's stdlib-only config parses gan_tpu's flags into the same
    fields, defaults and config.json."""
    assert ([(f.name, f.default) for f in dataclasses.fields(CycleGANConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jax_config.CycleGANConfig)])
    argv = ["--input-images", "x", "--output", "o", "--predict", "--weights", "w", *extra]
    assert parse_cyclegan(argv).to_json() == jax_config.parse_cyclegan(argv).to_json()


@pytest.mark.parametrize("argv", [
    ["--output", "o", "--predict", "--weights", "w"],                      # no --input-images
    ["--input-images", "x", "--output", "o", "--predict"],                 # no --weights
    ["--input-images", "x", "--output", "o", "--predict", "--weights", "w", "--channels", "2"],
    ["--input-images", "x", "--output", "o", "--train", "--epochs", "1"],  # no --target-images
])
def test_config_refuses_what_gan_tpu_refuses(argv):
    for parse in (parse_cyclegan, jax_config.parse_cyclegan):
        with pytest.raises(SystemExit):
            parse(argv)


def test_generate_batched_matches_gan_tpu(transplanted_run):
    """At 32² the U-Net has depth 5, whose up specs hold no dropout block, so
    both generators are deterministic here."""
    images, run, jax_trainer = transplanted_run
    cfg = parse_cyclegan(_argv(str(images), "unused", str(run)))
    trainer = CycleGANTrainer(cfg)
    assert trainer.gen_g.n_dropout == 0
    mgr = CheckpointManager(latest_checkpoint_dir(str(run)))
    assert mgr.latest_epoch() == 5
    trainer.load_state(mgr.restore())
    u8 = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 1), dtype=np.uint8)
    got = trainer.generate_batched(u8, chunk=2)
    want = np.asarray(jax_trainer.gen.apply(
        jax_trainer.params["gen_g"], jax_normalize_batch(jnp.asarray(u8)), rng=None))
    assert got.shape == (3, 32, 32, 1) and got.dtype == np.float32
    # fp32 on both sides, sums in different orders
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_generate_batched_dropout_is_keyed_by_chunk_offset(monkeypatch):
    """At 64² (depth 6, one dropout block) dropout is on at predict, and its
    draws are a pure function of (seed + 2, chunk offset)."""
    cfg = parse_cyclegan(["--input-images", "unused", "--output", "unused", "--predict",
                          "--weights", "unused", "--img-size", "64", "--dtype", "fp32"])
    trainer = CycleGANTrainer(cfg)
    with torch.no_grad():   # non-zero offsets, so the bottleneck carries signal
        for name, p in trainer.gen_g.named_parameters():
            if name.endswith("offset"):
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(0))
    u8 = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 1), dtype=np.uint8)
    out = trainer.generate_batched(u8, chunk=2)
    np.testing.assert_array_equal(out, trainer.generate_batched(u8, chunk=2))
    np.testing.assert_array_equal(out[:2], trainer.generate_batched(u8[:2], chunk=2))
    monkeypatch.setattr(port_blocks, "dropout", lambda x, rate, **kw: x)
    assert np.abs(out - trainer.generate_batched(u8, chunk=2)).max() > 1e-3


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for epoch in (5, 10, 15):
        mgr.save(epoch, {"w": torch.full((2,), float(epoch))})
    assert mgr.all_epochs() == [10, 15]
    assert mgr.restore()["w"][0].item() == 15.0
    assert mgr.restore(10)["w"][0].item() == 10.0
    assert sorted(os.listdir(tmp_path)) == ["10", "15"]


def test_checkpoint_manager_restore_creates_nothing(tmp_path):
    missing = tmp_path / "mistyped"
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CheckpointManager(latest_checkpoint_dir(str(missing))).restore()
    assert not missing.exists()
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path), max_to_keep=0)


@pytest.mark.parametrize("flags", [["--resume", "r"], ["--checkpoint-every", "2"],
                                   ["--num-devices", "2"]], ids=lambda f: f[0])
def test_train_is_refused(tmp_path, flags):
    """--train runs, but not with the flags whose paths are not ported yet."""
    argv = ["--input-images", str(tmp_path), "--target-images", str(tmp_path), "--output",
            str(tmp_path / "out"), "--train", "--epochs", "1", "--img-size", "32", *flags]
    with pytest.raises(SystemExit, match="not ported"):
        port_main(parse_cyclegan(argv))
    assert not (tmp_path / "out").exists()
