"""The device-side epoch (``train/loop.py``'s cached runner), ``--resume``,
``--checkpoint-every`` and ``utils/profiling.py``, for both trainers.

On the CPU (32², depth 5, batch 2, fp32) the runner's epoch is held bit for
bit to the per-step eager loop that ran every step before the runner
existed (kept here as the reference), and its static draw buffers to what
the keyed generators draw inside the eager step. On the card (``-m cuda``:
64², depth 6, batch 2, bf16) a CUDA-graph epoch is held to the eager epoch
from the same state, also after ``load_state``. This file imports no jax,
so the card's tests run where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_epoch.py
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gan_tpu_torch import cycle_gan, pix2pix
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.data import augment
from gan_tpu_torch.models import blocks
from gan_tpu_torch.train import base, loop
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.cyclegan_trainer import (BATCHED_PASSES, UNBATCHED_PASSES,
                                                   CycleGANTrainer, pass_widths)
from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
from torch_inputs import limit_threads

limit_threads()

TRAINERS = ["cyclegan", "pix2pix"]


def _trainer(kind: str, *extra, size: int = 32, dtype: str = "fp32"):
    common = ["--output", "o", "--train", "--epochs", "4", "--img-size", str(size),
              "--batch-size", "2", "--dtype", dtype, *extra]
    if kind == "cyclegan":
        return CycleGANTrainer(parse_cyclegan(["--input-images", "x", "--target-images", "y",
                                               *common]))
    return Pix2PixTrainer(parse_pix2pix(["--data", "d", *common]))


def _caches(kind: str, size: int, device, seed: int = 3):
    """(train caches, val caches) on ``device``: CycleGAN 5 X and 7 Y train
    rows (2 full steps and a zip tail of 1 X and 2 Y rows) and 4 + 5 val
    rows (2 full steps); Pix2Pix 5 train pairs (2 full steps and a 1-row
    remainder) and 3 val pairs (a full step and a remainder)."""
    rng = np.random.default_rng(seed)
    pad = size + augment.JITTER_PAD

    def u8(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)

    if kind == "cyclegan":
        return (u8(5, pad, pad, 1), u8(7, pad, pad, 1)), (u8(4, size, size, 1), u8(5, size, size, 1))
    return (u8(5, 2, pad, pad, 1),), (u8(3, 2, size, size, 1),)


def _old_epoch(trainer, caches, epoch: int, training: bool) -> np.ndarray:
    """The epoch as the trainers ran it before the runner: every step
    eager through ``_step``, the draws made inside it."""
    cfg = trainer.config
    b = cfg.batch_size
    stream = 0 if training else 1
    if isinstance(trainer, CycleGANTrainer):
        x_dev, y_dev = caches
        nx, ny = x_dev.shape[0], y_dev.shape[0]
        full, tail = loop.epoch_plan(min(nx, ny), b)
        rng = loop.epoch_rng(cfg.seed, epoch, stream)
        perm_x = torch.from_numpy(loop.epoch_perm(nx, cfg.buffer_size, rng)).to(trainer.device)
        perm_y = torch.from_numpy(loop.epoch_perm(ny, cfg.buffer_size, rng)).to(trainer.device)
        losses = [trainer._step(x_dev[perm_x[s * b:(s + 1) * b]], y_dev[perm_y[s * b:(s + 1) * b]],
                                epoch, stream, s)
                  for s in range(full + (tail > 0))]
    else:
        (cache,) = caches
        full, tail = loop.epoch_plan(cache.shape[0], b)
        losses = [trainer._step(cache[s * b:(s + 1) * b], epoch, stream, s)
                  for s in range(full + (tail > 0))]
    return torch.stack(losses).cpu().numpy()


def _run_epoch(trainer, caches, epoch: int, training: bool) -> np.ndarray:
    return trainer.run_epoch(*caches, epoch, training=training)


def _assert_same_state(a, b) -> None:
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
def test_runner_epoch_equals_the_eager_loop(kind):
    """Two train and two val epochs, the runner's CPU form against the old
    per-step loop from the same initial state: losses, every parameter and
    every Adam moment bit for bit (the same arithmetic on the same draws)."""
    new, old = _trainer(kind), _trainer(kind)
    train, val = _caches(kind, 32, new.device)
    for epoch in (0, 1):
        for caches, training in ((train, True), (val, False)):
            got = _run_epoch(new, caches, epoch, training)
            want = _old_epoch(old, caches, epoch, training)
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_array_equal(got, want, err_msg=f"epoch {epoch}, train {training}")
    _assert_same_state(new, old)
    assert new.epoch_counts == {"eager": 2 * 2 + 2 * (2 if kind == "cyclegan" else 1),
                                "captures": 0, "replays": 0}


@pytest.mark.parametrize("training", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("kind", TRAINERS)
def test_static_draw_buffers_equal_the_eager_draws(monkeypatch, kind, training):
    """Step 1 of epoch 3: the dropout keep-masks (every site of every
    generator pass, in call order: at batch 2 one Pix2Pix pass, or for
    CycleGAN at 64², whose U-Net has a dropout site, the batched form's
    three passes of 4, 6 and 2 rows and the unbatched form's six of 2, each
    form forced on a trainer of its own) and the jitter's offsets and flips
    that the keyed generators draw inside the eager ``_step`` equal
    ``_step_draws`` and what the runner's static buffers hold after it ran
    that step."""
    size = 64 if kind == "cyclegan" else 32
    seen = {"masks": [], "jitter": []}
    real_mask, real_jitter = blocks.keep_mask, augment.jitter_draws
    monkeypatch.setattr(blocks, "keep_mask", lambda *a, **kw: seen["masks"].append(
        real_mask(*a, **kw)) or seen["masks"][-1])
    monkeypatch.setattr(augment, "jitter_draws", lambda *a, **kw: seen["jitter"].append(
        real_jitter(*a, **kw)) or seen["jitter"][-1])
    stream = 0 if training else 1
    forms = {BATCHED_PASSES: 2, UNBATCHED_PASSES: -1} if kind == "cyclegan" else {None: None}
    for passes, limit in forms.items():
        trainer = _trainer(kind, size=size)
        if kind == "cyclegan":
            trainer.BATCHED_PASS_MAX = limit
            assert trainer.passes(2, 2) is passes
        train, val = _caches(kind, size, trainer.device)
        caches = train if training else val
        seen["masks"].clear()
        seen["jitter"].clear()
        trainer._step(*(c[:2] for c in caches), 3, stream, 1)
        n_passes = len(passes) if kind == "cyclegan" else 1
        assert len(seen["masks"]) == n_passes * trainer.sampler.n_dropout
        assert len(seen["jitter"]) == ((2 if kind == "cyclegan" else 1) if training else 0)
        want = seen["masks"] + [t for j in seen["jitter"] for t in j]

        draws = trainer._step_draws(3, stream, 1)
        assert [len(m) for m in draws.masks] == [trainer.sampler.n_dropout] * n_passes
        if kind == "cyclegan":
            assert trainer.sampler.n_dropout == 1
            assert [m[0].shape[0] for m in draws.masks] == pass_widths(passes, 2, 2)
        steps = torch.tensor([[1, 0], [0, 1]])   # the rows of steps 0 and 1
        trainer._cached_epoch(caches, tuple(steps for _ in caches), 3, training)
        ((_, idx, buffers),) = trainer._runners.values()
        for got in (draws.tensors(), buffers.tensors()):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
        assert all(torch.equal(i, steps[1]) for i in idx)


def test_pix2pix_run_epoch_takes_the_partial_last_batch():
    """5 pairs at batch 2: two full steps through the runner and the 1-row
    remainder as an eager step (3 steps), as the reference's tf.data batches
    without dropping the remainder; 3 val pairs: a full step and a 1-row
    remainder."""
    trainer = _trainer("pix2pix")
    (train,), (val,) = _caches("pix2pix", 32, trainer.device)
    widths = []
    real_losses = trainer._losses
    trainer._losses = lambda x, y, *a: widths.append(len(x)) or real_losses(x, y, *a)
    out = trainer.run_epoch(train, 0, training=True)
    assert widths == [2, 2, 1]
    assert out.shape == (3, 4) and np.isfinite(out).all()
    widths.clear()
    out = trainer.run_epoch(val, 0, training=False)
    assert widths == [2, 1] and out.shape == (2, 4)


@pytest.mark.parametrize("kind", TRAINERS)
def test_load_state_drops_the_cached_runners(kind):
    trainer = _trainer(kind)
    train, _ = _caches(kind, 32, trainer.device)
    _run_epoch(trainer, train, 0, True)
    assert len(trainer._runners) == 1
    _run_epoch(trainer, train, 1, True)
    assert len(trainer._runners) == 1   # the same runner serves the next epoch
    trainer.load_state(trainer.state())
    assert trainer._runners == {}
    _run_epoch(trainer, train, 2, True)
    assert len(trainer._runners) == 1


def _write_data(root, kind: str) -> list[str]:
    """PNGs for a CLI run; returns the data flags."""
    rng = np.random.default_rng(5)
    if kind == "pix2pix":
        data = root / "data"
        data.mkdir()
        for i in range(9):
            Image.fromarray(rng.integers(0, 255, (40, 72), np.uint8), "L").save(data / f"p{i}.png")
        return ["--data", str(data), "--validation-size", "0.3"]
    for d, n in (("x", 8), ("y", 7)):
        (root / d).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (40, 36), np.uint8), "L").save(
                root / d / f"{d}{i}.png")
    return ["--input-images", str(root / "x"), "--target-images", str(root / "y"),
            "--validation-size", "0.2"]


def _cli(kind: str, data: list[str], out, *extra) -> str:
    """Train through the port's CLI in this process; returns the run dir."""
    argv = [*data, "--output", str(out), "--train", "--img-size", "32", "--batch-size", "2",
            "--test-img", "2", "--dtype", "fp32", "--logging", "false", *extra]
    if kind == "pix2pix":
        pix2pix.main(parse_pix2pix(argv))
    else:
        cycle_gan.main(parse_cyclegan(argv))
    (run,) = glob.glob(str(out / "*"))
    return run


@pytest.mark.parametrize("kind", TRAINERS)
def test_resume_repeats_the_clean_run(tmp_path, capsys, kind):
    """2 epochs, then ``--resume <run> --epochs 4``, against a clean 4-epoch
    run: the resumed metrics equal the clean run's last two epochs, the
    final checkpoints hold equal tensors and the final test images are the
    same bytes (draws, shuffles and sample keys are pure in seed, epoch and
    index)."""
    data = _write_data(tmp_path, kind)
    clean = _cli(kind, data, tmp_path / "clean", "--epochs", "4")
    first = _cli(kind, data, tmp_path / "first", "--epochs", "2")
    capsys.readouterr()
    resumed = _cli(kind, data, tmp_path / "resumed", "--epochs", "4", "--resume", first)
    assert f"Resumed from {first} at epoch 2" in capsys.readouterr().out
    for name in ("train_metrics.json", "val_metrics.json"):
        with open(os.path.join(clean, "logs", name)) as f:
            want = {k: v[2:] for k, v in json.load(f).items()}
        with open(os.path.join(resumed, "logs", name)) as f:
            assert json.load(f) == want, name
    ckpt = lambda run: CheckpointManager(os.path.join(run, "training_checkpoints"))
    assert ckpt(resumed).latest_epoch() == ckpt(clean).latest_epoch() == 4
    got, want = ckpt(resumed).restore(), ckpt(clean).restore()

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    got_leaves, want_leaves = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert (torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w), path
    imgs = sorted(os.listdir(os.path.join(clean, "final_test_imgs")))
    assert imgs == ["img0.png", "img1.png"]
    for name in imgs:
        with open(os.path.join(clean, "final_test_imgs", name), "rb") as f:
            want_png = f.read()
        with open(os.path.join(resumed, "final_test_imgs", name), "rb") as f:
            assert f.read() == want_png, name


def _fit_with_stub_epochs(trainer, tmp_path, manager=None, start_epoch: int = 0,
                          on_epoch=None):
    """``fit`` with ``run_epoch`` replaced by zero losses of one step (what
    the epoch loop around it does is under test)."""
    keys = 7 if isinstance(trainer, CycleGANTrainer) else 4

    def run_epoch(*args, training):
        if on_epoch is not None:
            on_epoch(args[-1], training)
        torch.zeros(4).add_(1.0)   # some work for a trace to record
        return np.zeros((1, keys), np.float32)

    trainer.run_epoch = run_epoch
    s = trainer.config.img_size
    if isinstance(trainer, CycleGANTrainer):
        train = np.zeros((2, s + 30, s + 30, 1), np.uint8)
        val = np.zeros((2, s, s, 1), np.uint8)
        return trainer.fit(train, train, val, val, val, str(tmp_path), checkpoint_manager=manager,
                           start_epoch=start_epoch)
    train = np.zeros((2, 2, s + 30, s + 30, 1), np.uint8)
    val = np.zeros((2, 2, s, s, 1), np.uint8)
    return trainer.fit(train, val, val, str(tmp_path), checkpoint_manager=manager,
                       start_epoch=start_epoch)


@pytest.mark.parametrize("every,saved", [(3, [3, 4]), (5, [4])])
@pytest.mark.parametrize("kind", TRAINERS)
def test_checkpoint_every_saves_where_gan_tpu_does(monkeypatch, tmp_path, kind, every, saved):
    """4 epochs with ``--checkpoint-every 3``: a save after epoch 3, and the
    final one after epoch 4. With 5: only the final save, never the same
    epoch twice (gan_tpu/train/pix2pix_trainer.py:591-594). Before them the
    fault fence's anchor at epoch 0, which the first of them deletes."""
    trainer = _trainer(kind, "--checkpoint-every", str(every))
    calls = []
    real_save = CheckpointManager.save
    monkeypatch.setattr(CheckpointManager, "save", lambda self, epoch, state, **kw: calls.append(
        (epoch, kw.get("anchor", False))) or real_save(self, epoch, state, **kw))
    manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    _fit_with_stub_epochs(trainer, tmp_path, manager)
    assert calls == [(0, True)] + [(epoch, False) for epoch in saved]
    assert manager.all_epochs() == saved


@pytest.mark.parametrize("kind", TRAINERS)
def test_perf_line_and_profile_trace(monkeypatch, tmp_path, capsys, kind):
    """``GAN_TPU_PERF=1`` prints each epoch's rate; ``GAN_TPU_PROFILE_DIR``
    traces epoch start_epoch + 1 alone, into a Chrome trace file."""
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("GAN_TPU_PERF", "1")
    monkeypatch.setenv("GAN_TPU_PROFILE_DIR", str(trace_dir))
    traced, trained = [], []
    real_trace = base.trace

    def recording_trace(logdir):
        # fit enters trace() just before an epoch's training: its epoch
        traced.append((1 + len(trained), logdir))
        return real_trace(logdir)

    monkeypatch.setattr(base, "trace", recording_trace)
    trainer = _trainer(kind)
    on_epoch = lambda epoch, training: trained.append(epoch) if training else None
    _fit_with_stub_epochs(trainer, tmp_path, start_epoch=1, on_epoch=on_epoch)
    assert trained == [1, 2, 3]
    assert traced == [(1, None), (2, str(trace_dir)), (3, None)]
    out = capsys.readouterr().out
    unit = "image-pairs" if kind == "cyclegan" else "images"
    for epoch in (2, 3, 4):
        assert f"[perf] epoch {epoch}: " in out and f" {unit}/sec (" in out
    (path,) = glob.glob(str(trace_dir / "*.json"))
    with open(path) as f:
        assert "traceEvents" in json.load(f)


# ------------------------------------------------------------------- the card
# Graph epoch against eager epoch, bf16 at 64²: the same kernels in the same
# order, but cuDNN's weight-gradient convolutions may sum with atomics, so
# even two eager runs may differ in the last bits, and Adam's first updates,
# lr·g/(|g| + 1e-7), turn such noise near g = 0 into a flip of up to 2·lr.
# Losses: STEP_TOL's bf16 loss tolerance (chip_smoke.py), relative.
GRAPH_LOSS_RTOL = 2e-2


@pytest.fixture
def cuda_trainers(monkeypatch):
    """Trainers on the card (the harness's GAN_TPU_PLATFORM=cpu lifted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    monkeypatch.delenv("GAN_TPU_PLATFORM", raising=False)
    monkeypatch.setenv("GAN_TPU_ALLOW_ANY_SIZE", "1")
    return lambda kind: _trainer(kind, size=64, dtype="bf16")


def _assert_close_losses(got, want, what):
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"{what}: largest relative loss difference {err:.3e} (tol {GRAPH_LOSS_RTOL:g})")
    assert got.shape == want.shape and np.isfinite(got).all()
    assert err <= GRAPH_LOSS_RTOL, what


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TRAINERS)
def test_graph_epoch_matches_eager_epoch(cuda_trainers, kind):
    """Two epochs from the same initial state: the runner's (the first full
    step eager as the capture's warm-up, then replays; the second epoch all
    replays) against the old eager loop, train and val."""
    graph, eager = cuda_trainers(kind), cuda_trainers(kind)
    assert graph.device.type == "cuda"
    train, val = _caches(kind, 64, graph.device)
    for epoch in (0, 1):
        for caches, training in ((train, True), (val, False)):
            got = _run_epoch(graph, caches, epoch, training)
            want = _old_epoch(eager, caches, epoch, training)
            _assert_close_losses(got, want, f"{kind} epoch {epoch}, train {training}")
    val_steps = 2 if kind == "cyclegan" else 1
    assert graph.epoch_counts == {"eager": 2, "captures": 2,
                                  "replays": (2 - 1) + 2 + (val_steps - 1) + val_steps}
    steps = int(graph.opts[next(iter(graph.opts))].state_dict()["state"][0]["step"])
    assert steps == 2 * 3   # two epochs of 2 full steps and a tail: no warm-up step leaked


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TRAINERS)
def test_graph_epoch_recaptures_after_load_state(cuda_trainers, kind):
    """After ``load_state`` of another trainer's state, the next graph epoch
    captures anew and equals an eager epoch from the loaded state."""
    graph, eager, source = (cuda_trainers(kind) for _ in range(3))
    train, _ = _caches(kind, 64, graph.device)
    _run_epoch(graph, train, 0, True)
    _old_epoch(source, train, 0, True)
    _old_epoch(source, train, 1, True)
    buf = io.BytesIO()   # through a file, as --resume loads it: no tensor is shared
    torch.save(source.state(), buf)
    for trainer in (graph, eager):
        buf.seek(0)
        trainer.load_state(torch.load(buf, map_location="cpu", weights_only=True))
    got = _run_epoch(graph, train, 2, True)
    want = _old_epoch(eager, train, 2, True)
    assert graph.epoch_counts["captures"] == 2
    _assert_close_losses(got, want, f"{kind} after load_state")


def test_chip_smoke_derives_the_graph_epoch_launches():
    """chip_smoke.py's counts of one ``fit`` epoch: the card runs every
    step's kernels (CycleGAN at batch 8: S 65, K1 624 and K2 594 in the
    batched form, S 130, K1 1,248 and K2 1,122 in the unbatched form; S 33
    for Pix2Pix at batch 32), the host traces them only for each runner's
    warm-up step, its capture and the tails; the rest replay. Phase 7 holds
    the unbatched form, which the card's crossover selects at 256², batch
    8."""
    import chip_smoke as c

    assert not c.cyclegan_batched(256, 8)
    for batched, (k1, k2, stems), ran_want, traced_want in (
            (True, (48, 54, 5), (624, 594, 65), (48 * 5, 54 * 3, 5 * 5)),
            (False, (96, 102, 10), (1248, 1122, 130), (96 * 5, 102 * 3, 10 * 5))):
        assert c.train_step_launches(14, 3, batched) == (k1, k2)
        per = {"instance_norm_fwd": k1, "instance_norm_bwd": k2, "stem_conv": stems}
        assert c.cyclegan_launches(256, batched) == (per, dict(per, instance_norm_bwd=0))
        ran, traced, counts = c.epoch_plan_counts(per, dict(per, instance_norm_bwd=0),
                                                  divmod(84, 8), divmod(16, 8))
        names = ("instance_norm_fwd", "instance_norm_bwd", "stem_conv")
        assert ran == dict(zip(names, ran_want))
        assert traced == dict(zip(names, traced_want))
        assert counts == {"eager": 2, "captures": 2, "replays": 9 + 1}
    per = {"instance_norm_fwd": 0, "instance_norm_bwd": 0, "stem_conv": 3}
    ran, traced, counts = c.epoch_plan_counts(per, per, divmod(261, 32), divmod(40, 32))
    assert ran["stem_conv"] == 33 and traced["stem_conv"] == 3 * 6
    assert counts == {"eager": 2, "captures": 2, "replays": 7}
