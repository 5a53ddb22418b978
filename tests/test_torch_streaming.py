"""The port's streamed epochs and predict over files (counterpart of
tests/test_streaming.py), for both trainers.

On the CPU (32², depth 5, batch 2, fp32) a streamed epoch, from a host
array (``--device-cache off``) or from FileCaches of PNGs (``--host-cache
off``), is held bit for bit to the resident epoch from the same state:
losses, then every parameter and Adam moment, train and val, with a partial
last batch. Both CLIs train with either cache off and write what they write
with the defaults; ``--predict --host-cache off`` writes the same PNG bytes.
On the card (``-m cuda``: 64², bf16) a streamed graph epoch is held to the
resident graph epoch. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_streaming.py
"""

import glob
import json
import os
import re
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from gan_tpu_torch import cycle_gan, pix2pix
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.parallel import world_size
from gan_tpu_torch.data import pipeline
from gan_tpu_torch.data.loader import FileCache
from gan_tpu_torch.train import base
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.utils import figs
from test_torch_epoch import (TRAINERS, _assert_same_state, _cli,
                              _trainer, _write_data, cuda_trainers)  # noqa: F401 (a fixture)
from torch_inputs import limit_threads

limit_threads()

SIZE = 32
# PNGs per set at batch 2: CycleGAN 3 X and 5 Y train rows and 3 + 4 val rows
# (each a full step and a zip tail of 1 X and 2 Y rows); Pix2Pix 5 train pairs
# (2 full steps and a 1-row remainder) and 3 val pairs (a full step and a
# remainder)
SETS = {"cyclegan": {"train_x": 3, "train_y": 5, "val_x": 3, "val_y": 4},
        "pix2pix": {"train": 5, "val": 3}}
# (epoch, training): a train epoch and two val epochs, so that the val
# stream's buffers serve a second epoch
EPOCHS = ((0, True), (0, False), (1, False))


def _sets(root, kind: str, size: int = SIZE, seed: int = 5):
    """Seeded PNGs of each set; returns {set: [paths]} and ``rows(train)``,
    the split's :class:`pipeline.Rows` (the native decoder)."""
    rng = np.random.default_rng(seed)
    shape = (size + 8, 2 * size + 8) if kind == "pix2pix" else (size + 8, size + 4)
    sets = {}
    for name, n in SETS[kind].items():
        os.makedirs(root / name)
        sets[name] = []
        for i in range(n):
            path = str(root / name / f"{i}.png")
            Image.fromarray(rng.integers(0, 256, shape, np.uint8), "L").save(path)
            sets[name].append(path)
    if kind == "pix2pix":
        rows = lambda train: pipeline.pix2pix_rows(img_size=size, channels=1, orient="left",
                                                   train=train)
    else:
        rows = lambda train: pipeline.cyclegan_rows(img_size=size, channels=1, train=train)
    return sets, rows


def _groups(kind: str, sets: dict, rows, source: str, batch: int = 2):
    """(train caches, val caches) on the host: decoded arrays, or FileCaches
    of the same files."""
    out = {}
    for name, paths in sets.items():
        split = rows(name.startswith("train"))
        out[name] = split(paths) if source == "array" else FileCache(paths, split, batch)
    if kind == "pix2pix":
        return (out["train"],), (out["val"],)
    return (out["train_x"], out["train_y"]), (out["val_x"], out["val_y"])


def _on_device(caches, device):
    return tuple(torch.from_numpy(np.stack(list(c.epoch())) if isinstance(c, FileCache)
                                  else c).to(device) for c in caches)


@pytest.fixture(scope="module")
def resident_runs(tmp_path_factory):
    """Per kind, made on first use: the PNG sets, and a trainer after the
    ``EPOCHS`` on the decoded caches resident on the device, with its
    losses."""
    runs = {}

    def get(kind):
        if kind not in runs:
            sets, rows = _sets(tmp_path_factory.mktemp(kind), kind)
            resident = _trainer(kind)
            device = tuple(_on_device(g, resident.device)
                           for g in _groups(kind, sets, rows, "array"))
            losses = [resident.run_epoch(*device[1 - training], epoch, training=training)
                      for epoch, training in EPOCHS]
            runs[kind] = sets, rows, resident, losses
        return runs[kind]

    return get


@pytest.mark.parametrize("source", ["array", "files"])
@pytest.mark.parametrize("kind", TRAINERS)
def test_streamed_epoch_equals_the_resident_epoch(resident_runs, kind, source):
    """A train epoch and two val epochs from the same initial state,
    streamed from the host against resident on the device: losses, every
    parameter and every Adam moment bit for bit. The stream's buffers are
    made once per (train or val, batch shapes) and kept across epochs, and
    no thread outlives an epoch."""
    sets, rows, resident, want = resident_runs(kind)
    host = _groups(kind, sets, rows, source)
    streamed = _trainer(kind)
    before = set(threading.enumerate())
    got = [streamed.run_epoch(*host[1 - training], epoch, training=training)
           for epoch, training in EPOCHS]
    assert set(threading.enumerate()) == before
    for (epoch, training), g, w in zip(EPOCHS, got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert len(g) == (3 if training and kind == "pix2pix" else 2)
        np.testing.assert_array_equal(g, w, err_msg=f"epoch {epoch}, train {training}")
    _assert_same_state(streamed, resident)
    assert len(streamed._streams) == 2 and streamed.epoch_counts == resident.epoch_counts
    assert all(buf.shape[0] == 2 for s in streamed._streams.values() for buf in s.buffers)


def test_a_failing_file_ends_the_streamed_epoch_and_its_threads(tmp_path):
    """A file the decoder refuses (the third, cut short) raises from
    ``run_epoch``, naming it, and leaves no thread running."""
    sets, rows = _sets(tmp_path, "pix2pix")
    paths = sets["train"]
    with open(paths[2], "rb") as f:
        head = f.read(100)
    with open(paths[2], "wb") as f:
        f.write(head)
    cache = FileCache(paths, rows(True), 2)
    trainer = _trainer("pix2pix")
    before = set(threading.enumerate())
    with pytest.raises(OSError, match=re.escape(paths[2])):
        trainer.run_epoch(cache, 0, training=True)
    assert set(threading.enumerate()) == before


def _tree(run: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), run)
                  for d, _, files in os.walk(run) for f in files)


@pytest.mark.parametrize("kind", TRAINERS)
def test_clis_train_with_the_caches_off(tmp_path, capsys, monkeypatch, kind):
    """``--host-cache off`` (FileCaches) and ``--device-cache off`` (host
    arrays) against the defaults, one epoch: the same file tree, config.json
    but for the flags and the output path, the same metrics, final test
    images and checkpoint; each prints gan_tpu's lines. The loss figures are
    written as empty files under their names (their data are the metrics,
    compared here; matplotlib would take most of the test's time)."""
    monkeypatch.setattr(figs, "make_fig", lambda train, val, title, output_path: (
        os.makedirs(output_path, exist_ok=True),
        open(os.path.join(output_path, f"{title}.png"), "wb").close()))
    data = _write_data(tmp_path, kind)
    n_train = 4 if kind == "cyclegan" else 2   # caches that stream under --host-cache off
    runs = {}
    for flag in ("defaults", "--host-cache", "--device-cache"):
        capsys.readouterr()
        extra = [] if flag == "defaults" else [flag, "off"]
        runs[flag] = _cli(kind, data, tmp_path / flag.strip("-"), "--epochs", "1",
                          "--test-img", "1", *extra)
        out = capsys.readouterr().out
        assert out.count("Host cache disabled for") == (n_train if flag == "--host-cache" else 0)
        assert ("Device cache plan: train=stream, val=stream" in out) == (flag != "defaults")
    want_tree = _tree(runs["defaults"])
    assert "logs/train_metrics.json" in want_tree
    for flag in ("--host-cache", "--device-cache"):
        run = runs[flag]
        assert _tree(run) == want_tree, flag
        configs = []
        for r in (run, runs["defaults"]):
            with open(os.path.join(r, "logs", "config.json")) as f:
                cfg = json.load(f)
            configs.append({k: v for k, v in cfg.items()
                            if k not in ("output", "host_cache", "device_cache")})
        assert configs[0] == configs[1]
        for name in ("logs/train_metrics.json", "logs/val_metrics.json",
                     "final_test_imgs/img0.png"):
            with open(os.path.join(run, name), "rb") as f, \
                    open(os.path.join(runs["defaults"], name), "rb") as g:
                assert f.read() == g.read(), (flag, name)
        ckpt = lambda r: CheckpointManager(os.path.join(r, "training_checkpoints")).restore()
        _assert_state_dicts_equal(ckpt(run), ckpt(runs["defaults"]))


def _assert_state_dicts_equal(a, b, path=()):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_state_dicts_equal(a[k], b[k], path + (k,))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_dicts_equal(x, y, path + (i,))
    else:
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, path


@pytest.mark.parametrize("kind", TRAINERS)
def test_predict_host_cache_off_writes_the_same_pngs(tmp_path, monkeypatch, kind):
    """``--predict --host-cache off`` (a FileCache of batch 2) against the
    in-memory predict of 2 images, in chunks of 1 so that chunk k + 1 is
    inferred before chunk k is written: the same grid and raw PNG bytes."""
    monkeypatch.setattr(base, "PREDICT_CHUNK", 1)
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(9)
    shape = (40, 72) if kind == "pix2pix" else (40, 36)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, shape, np.uint8), "L").save(images / f"im{i}.png")
    run = tmp_path / "run"
    CheckpointManager(str(run / "training_checkpoints")).save(1, _trainer(kind).state())
    written = {}
    for flag in ("defaults", "--host-cache"):
        out = tmp_path / flag.strip("-")
        argv = ["--output", str(out), "--predict", "--weights", str(run), "--img-size", str(SIZE),
                "--batch-size", "2", "--logging", "false", "--dtype", "fp32",
                "--raw-predictions", "true", *([] if flag == "defaults" else [flag, "off"])]
        if kind == "pix2pix":
            pix2pix.main(parse_pix2pix(["--data", str(images), *argv]))
        else:
            cycle_gan.main(parse_cyclegan(["--input-images", str(images), *argv]))
        (root,) = glob.glob(str(out / "*"))
        written[flag] = {name: open(os.path.join(root, name), "rb").read()
                         for name in _tree(root) if name.endswith(".png")}
    assert sorted(written["defaults"]) == sorted(
        [f"prediction_images/img{i}.png" for i in range(2)]
        + [f"prediction_images_raw/im{i}.png" for i in range(2)])
    assert written["--host-cache"] == written["defaults"]


@pytest.mark.parametrize("kind", TRAINERS)
def test_refuse_unported_refuses_only_data_parallelism(kind):
    """Data parallelism is ported, so nothing is refused any more: the flags
    that passed the old refusal train one replica (the CPU counts as one
    device for --num-devices 0), ``--num-devices 2`` trains two where they
    divide the batch, and exits where they do not."""
    first = (["--data", "d"] if kind == "pix2pix"
             else ["--input-images", "x", "--target-images", "y"])
    parse = parse_pix2pix if kind == "pix2pix" else parse_cyclegan
    train = [*first, "--output", "o", "--train", "--epochs", "1"]
    for flags in (["--host-cache", "off"], ["--device-cache", "off"], ["--num-devices", "1"],
                  ["--host-cache", "on", "--device-cache", "on"]):
        cfg = parse([*train, *flags])
        assert world_size(cfg.num_devices, cfg.batch_size, present=1) == 1
    cfg = parse([*train, "--num-devices", "2", "--batch-size", "2"])
    assert world_size(cfg.num_devices, cfg.batch_size, present=8) == 2
    with pytest.raises(SystemExit, match="global batch of 1 does not divide over 2 replicas"):
        cfg = parse([*train, "--num-devices", "2"])
        world_size(cfg.num_devices, cfg.batch_size, present=8)


# ------------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("kind", TRAINERS)
def test_streamed_graph_epoch_matches_the_resident_graph_epoch(cuda_trainers, tmp_path, kind):
    """Two epochs from FileCaches against two resident epochs, both as
    CUDA-graph epochs at 64² in bf16: the streamed runner is its own capture
    (one per train and val, kept across epochs). Both run the same kernels
    on the same bytes in the same order, so losses, parameters and Adam's
    state are equal bit for bit: a step that read a stale or the next batch
    from the stream's buffers would differ."""
    sets, rows = _sets(tmp_path, kind, size=64)
    host = _groups(kind, sets, rows, "files")
    streamed, resident = cuda_trainers(kind), cuda_trainers(kind)
    device = tuple(_on_device(g, resident.device) for g in _groups(kind, sets, rows, "array"))
    for epoch in (0, 1):
        for group, training in ((0, True), (1, False)):
            got = streamed.run_epoch(*host[group], epoch, training=training)
            want = resident.run_epoch(*device[group], epoch, training=training)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} epoch {epoch}, "
                                                             f"train {training}")
    _assert_same_state(streamed, resident)
    assert streamed.epoch_counts == resident.epoch_counts
    assert streamed.epoch_counts["captures"] == 2 and len(streamed._streams) == 2
