"""``python -m gan_tpu_torch.pix2pixhd`` on the CPU: a tiny folder in
pix2pixHD's Cityscapes layout (seeded 8-bit label PNGs, 16-bit instance
PNGs whose ids pass 255, RGB images) through ``--train`` for one epoch,
``--resume`` to a second, equal to a clean two-epoch run, and ``--predict``;
the output tree the other CLIs write; the refusal to train the VGG loss
without ``--vgg_weights``; and the native rows against the PIL twin."""

import json
import os

import numpy as np
import pytest
import torch

from gan_tpu_torch import pix2pixhd
from gan_tpu_torch.config import parse_pix2pixhd
from gan_tpu_torch.data import pipeline
from gan_tpu_torch.models.vgg import VGG19Trunk
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from torch_inputs import limit_threads, write_png

limit_threads()

TINY = ["--loadSize", "64", "--ngf", "8", "--n_downsample_global", "2", "--n_blocks_global",
        "2", "--ndf", "16", "--dtype", "fp32", "--batchSize", "2", "--test-img", "2",
        "--logging", "false"]
KEYS = ["G_GAN", "G_GAN_Feat", "G_VGG", "D_real", "D_fake"]


def write_city(root, phase: str, n: int, seed: int, img: bool = True) -> None:
    """n rows of 128x64 files: labels over 8x8 cells, instance ids (16 bit,
    some past 255) over 16x16 cells, RGB noise."""
    rng = np.random.default_rng(seed)
    for kind in ("label", "inst") + (("img",) if img else ()):
        os.makedirs(os.path.join(root, f"{phase}_{kind}"), exist_ok=True)
    for i in range(n):
        lab = np.kron(rng.integers(0, 35, (8, 16)), np.ones((8, 8), np.int64))
        inst = np.kron(rng.integers(0, 65536, (4, 8)), np.ones((16, 16), np.int64))
        name = f"city_{i:03d}"
        write_png(os.path.join(root, f"{phase}_label", name + "_gtFine_labelIds.png"),
                  lab[..., None], color=0, depth=8)
        write_png(os.path.join(root, f"{phase}_inst", name + "_gtFine_instanceIds.png"),
                  inst[..., None], color=0, depth=16)
        if img:
            write_png(os.path.join(root, f"{phase}_img", name + "_leftImg8bit.png"),
                      rng.integers(0, 256, (64, 128, 3)), color=2, depth=8)


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    root = tmp_path_factory.mktemp("city")
    write_city(str(root), "train", 7, 0)
    write_city(str(root), "test", 3, 1, img=False)
    vgg = VGG19Trunk(torch.Generator().manual_seed(2)).state_dict()
    vgg["classifier.0.weight"] = torch.zeros(2, 2)   # a torchvision dict's other keys
    torch.save(vgg, str(root / "vgg19.pth"))
    return root


def run(city, out, *args) -> str:
    pix2pixhd.main(parse_pix2pixhd(["--dataroot", str(city), "--output", str(out), *TINY,
                                    *args]))
    (run_dir,) = [os.path.join(out, d) for d in os.listdir(out)]
    return run_dir


def train(city, out, *args) -> str:
    return run(city, out, "--train", "--vgg_weights", str(city / "vgg19.pth"), *args)


def metrics(run_dir: str, split: str) -> dict:
    with open(os.path.join(run_dir, "logs", f"{split}_metrics.json")) as f:
        return json.load(f)


def test_train_resume_and_predict_write_the_other_clis_tree(city, tmp_path, capsys):
    one = train(city, tmp_path / "one", "--epochs", "1")
    assert sorted(os.listdir(one)) == ["figs", "final_test_imgs", "logs", "test_images",
                                       "training_checkpoints"]
    assert sorted(os.listdir(os.path.join(one, "figs"))) == sorted(
        f"pix2pixHD {k}.png" for k in KEYS)
    assert sorted(os.listdir(os.path.join(one, "final_test_imgs"))) == ["img0.png", "img1.png"]
    assert os.listdir(os.path.join(one, "training_checkpoints")) == ["1"]
    assert list(metrics(one, "train")) == KEYS and len(metrics(one, "val")["G_GAN"]) == 1
    with open(os.path.join(one, "logs", "config.json")) as f:
        config = json.load(f)
    assert config["label_nc"] == 35 and config["n_blocks_global"] == 2 and config["num_D"] == 2
    state = CheckpointManager(latest_checkpoint_dir(one)).restore()
    assert set(state["params"]) == set(state["opt_states"]) == {"gen", "disc_0", "disc_1"}

    resumed = train(city, tmp_path / "resumed", "--epochs", "2", "--resume", one)
    assert f"Resumed from {one} at epoch 1" in capsys.readouterr().out
    clean = train(city, tmp_path / "clean", "--epochs", "2")
    for split in ("train", "val"):
        for k in KEYS:
            assert metrics(resumed, split)[k] == metrics(clean, split)[k][1:]
    a = CheckpointManager(latest_checkpoint_dir(resumed)).restore()
    b = CheckpointManager(latest_checkpoint_dir(clean)).restore()
    for net in a["params"]:
        for k, t in a["params"][net].items():
            assert torch.equal(t, b["params"][net][k]), (net, k)

    predicted = run(city, tmp_path / "predict", "--predict", "--weights", one)
    assert sorted(os.listdir(os.path.join(predicted, "prediction_images"))) == [
        "img0.png", "img1.png", "img2.png"]


def test_training_the_vgg_loss_without_its_weights_is_refused(city, tmp_path):
    with pytest.raises(SystemExit, match="--vgg_weights"):
        run(city, tmp_path / "o", "--train", "--epochs", "1")
    assert not (tmp_path / "o").exists()


def test_no_vgg_loss_trains_without_weights(city, tmp_path):
    one = run(city, tmp_path / "o", "--train", "--epochs", "1", "--no_vgg_loss")
    assert metrics(one, "train")["G_VGG"] == [0.0]


def test_native_rows_equal_the_pil_twin(city, monkeypatch):
    labels = sorted(os.listdir(city / "train_label"))
    triples = [(str(city / "train_label" / n),
                str(city / "train_inst" / n.replace("labelIds", "instanceIds")),
                str(city / "train_img" / n.replace("gtFine_labelIds", "leftImg8bit")))
               for n in labels[:3]]
    triples.append((triples[0][0], None, None))
    rows = pipeline.pix2pixhd_rows(height=32, width=64, threads=2)
    native = rows(triples)
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")
    twin = rows(triples)
    np.testing.assert_array_equal(native, twin)
    ids = native[:3, ..., 1].astype(np.int64) * 256 + native[:3, ..., 2]
    assert ids.max() > 255 and not native[3, ..., 1:].any()
    assert pipeline.hd_size(triples[0][0], 64, 4) == (32, 64)
