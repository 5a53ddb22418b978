"""The port's fault fence (gan_tpu_torch/train/recovery.py) against gan_tpu's
(gan_tpu/train/recovery.py and tests/test_recovery.py).

Case by case, the port's ``is_device_fault`` answers as gan_tpu's and takes
torch's CUDA, out-of-memory and collective errors as faults; both packages'
``FaultFence`` give the same rewinds, exceptions and emergency saves over
one schedule of faults, checkpoints and restore failures; anchor saves leave
the epochs gan_tpu's checkpoint manager leaves. Then both CLIs at
32², fp32, batch 2, 6 epochs with ``--checkpoint-every 2``: a fault at the
entry of the 4th train epoch, one at its 2nd step (after that step updated
the parameters in place) and a transient OSError in a ``--host-cache off``
epoch are rewound in-process, and the run equals the clean one (metrics,
sample PNG bytes, the final checkpoint's tensors), with no anchor left in
``training_checkpoints/``; a CycleGAN epoch from two FileCaches ends every
thread while its fault is still held; a fault storm exits 17 resume-ready and
``--resume`` finishes the run; logic and filesystem errors pass through;
and over two gloo ranks a fault on rank 1 ends the run with exit 17.
"""

import glob
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from gan_tpu.train import recovery as jax_recovery
from gan_tpu_torch import cycle_gan, parallel, pix2pix
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.data import pipeline
from gan_tpu_torch.data.loader import FileCache
from gan_tpu_torch.train import loop, recovery
from gan_tpu_torch.train.checkpoint import CheckpointManager
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer
from torch_inputs import limit_threads

limit_threads()

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
KINDS = ["pix2pix", "cyclegan"]
TRAINER = {"pix2pix": Pix2PixTrainer, "cyclegan": CycleGANTrainer}
RESUME_LINE = "Resume with the original flags plus: --resume "
DIST_TIMEOUT = 180   # seconds for the two-rank run, the parent's spawn included

# ------------------------------------------------------------ classification

# gan_tpu's cases (tests/test_recovery.py:17-31) and more of the builtin kinds
CASES = {
    "runtime": lambda: RuntimeError("worker unavailable"),
    "os": lambda: OSError("tunnel reset"),
    "connection": lambda: ConnectionError("grpc"),
    "broken_pipe": lambda: BrokenPipeError("peer gone"),
    "timeout": lambda: TimeoutError("read timed out"),
    "not_implemented": lambda: NotImplementedError("a RuntimeError kind"),
    "value": lambda: ValueError("bad shape"),
    "type": lambda: TypeError("bad arg"),
    "assertion": lambda: AssertionError("contract"),
    "key": lambda: KeyError("missing"),
    "file_not_found": lambda: FileNotFoundError("no such dir"),
    "permission": lambda: PermissionError("read-only output"),
    "not_a_directory": lambda: NotADirectoryError("file in the way"),
    "is_a_directory": lambda: IsADirectoryError("dir in the way"),
    "file_exists": lambda: FileExistsError("collision"),
    "keyboard_interrupt": lambda: KeyboardInterrupt(),
}
# torch's errors on the card's paths, all RuntimeErrors and so faults
TORCH_FAULTS = {
    "cuda": lambda: torch.AcceleratorError("CUDA error: an illegal memory access"),
    "out_of_memory": lambda: torch.OutOfMemoryError("CUDA out of memory"),
    "dist_backend": lambda: dist.DistBackendError("NCCL error: unhandled system error"),
    "graph_capture": lambda: RuntimeError("capturing the epoch step into a CUDA graph failed"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_is_device_fault_matches_gan_tpu(case):
    exc = CASES[case]()
    assert recovery.is_device_fault(exc) == jax_recovery.is_device_fault(exc)


@pytest.mark.parametrize("case", sorted(TORCH_FAULTS))
def test_torch_errors_are_faults(case):
    exc = TORCH_FAULTS[case]()
    assert recovery.is_device_fault(exc) and jax_recovery.is_device_fault(exc)


# ------------------------------------------------------------- the anchor

# (max_to_keep, [(epoch, anchor) of each save])
ANCHOR_SAVES = {
    "deleted_by_the_first_real_save": (3, [(0, True), (2, False), (4, False)]),
    "kept_without_a_real_save": (3, [(0, True)]),
    "kept_when_its_epoch_is_saved_again": (3, [(0, True), (0, False)]),
    "at_a_resumed_epoch_with_max_to_keep_1": (1, [(3, True), (5, False), (6, False)]),
    "emergency_save_after_it": (3, [(2, True), (3, False)]),
}


@pytest.mark.parametrize("name", sorted(ANCHOR_SAVES))
def test_anchor_saves_match_gan_tpu(tmp_path, name):
    """``save(anchor=True)``: the same epochs remain in both packages'
    checkpoint directories after the same saves
    (gan_tpu/train/checkpoint.py:30-48)."""
    from gan_tpu.train.checkpoint import CheckpointManager as JaxManager

    keep, saves = ANCHOR_SAVES[name]
    port = CheckpointManager(str(tmp_path / "port"), max_to_keep=keep)
    ref = JaxManager(str(tmp_path / "jax"), max_to_keep=keep)
    for epoch, anchor in saves:
        port.save(epoch, {"w": torch.ones(2)}, anchor=anchor)
        ref.save(epoch, {"w": np.ones(2, np.float32)}, anchor=anchor)
    assert port.all_epochs() == sorted(ref._mgr.all_steps())
    ref.close()


# ------------------------------------------------------------------- fence

class _StubManager:
    """latest_epoch / save / restore / directory, recording the saves and
    the restores; ``restore_fails`` and ``save_fails`` make them raise."""

    def __init__(self, latest, restore_fails=False, save_fails=False):
        self.latest, self.restore_fails, self.save_fails = latest, restore_fails, save_fails
        self.directory = "/run/training_checkpoints"
        self.saves, self.restores = [], 0

    def latest_epoch(self):
        return self.latest

    def save(self, epoch, state, **kw):
        if self.save_fails:
            raise OSError("disk full")
        self.saves.append(epoch)
        self.latest = epoch

    def restore(self, *args, **kw):   # gan_tpu passes a target; the port a map_location
        self.restores += 1
        if self.restore_fails:
            raise RuntimeError("restore failed: worker dead")
        return {"w": np.zeros(2, np.float32)}


class _StubTrainer:
    device = torch.device("cpu")
    replicas = parallel.single(torch.device("cpu"))

    def __init__(self, fetch_fails=False):
        self.fetch_fails, self.loads = fetch_fails, 0

    def state(self):
        if self.fetch_fails:
            raise RuntimeError("device state unfetchable")
        return {"w": np.ones(2, np.float32)}

    def load_state(self, state):
        self.loads += 1


TrainingFaults = (recovery.TrainingFault, jax_recovery.TrainingFault)
F = RuntimeError   # a fault
# name: (GAN_TPU_FAULT_RETRIES, the manager's latest epoch (None: no
# checkpoint; "none": no manager), restore fails, state and save fail,
# [(epoch, exception kind) of each recover call])
SCHEDULES = {
    "one_rewind": (3, 2, False, False, [(3, F)]),
    "rewinds_then_the_latest_epoch": (3, 2, False, False, [(2, F)] * 4),
    "rewinds_then_an_emergency_save": (3, 2, False, False, [(3, F)] * 4),
    "os_and_connection_faults": (3, 4, False, False, [(5, OSError), (4, ConnectionError)]),
    "no_checkpoint_yet": (3, None, False, False, [(0, F)]),
    "no_manager": (3, "none", False, False, [(1, F)]),
    "restore_fails": (3, 2, True, False, [(3, F)]),
    "restore_and_fetch_fail": (3, 2, True, True, [(3, F)]),
    "one_retry": (1, 2, False, False, [(3, F), (2, F)]),
    "retries_off": (0, 2, False, False, [(3, F)]),
    "logic_error": (3, 2, False, False, [(3, ValueError)]),
    "filesystem_error": (3, 2, False, False, [(3, FileNotFoundError)]),
    "fault_then_logic_error": (3, 2, False, False, [(3, F), (2, AssertionError)]),
}


def _drive(fence_cls, schedule, monkeypatch):
    """Each recover call's outcome, the manager's saves and the states the
    trainer loaded, for one package's FaultFence."""
    retries, latest, restore_fails, fetch_fails, calls = schedule
    monkeypatch.setenv("GAN_TPU_FAULT_RETRIES", str(retries))
    manager = None if latest == "none" else _StubManager(latest, restore_fails, fetch_fails)
    trainer = _StubTrainer(fetch_fails)
    fence = fence_cls(trainer, manager)
    outcomes = []
    for epoch, kind in calls:
        exc = kind(f"injected at epoch {epoch}")
        try:
            outcomes.append(("rewound to", fence.recover(epoch, exc)))
        except TrainingFaults as fault:
            outcomes.append(("fault", fault.epoch, fault.checkpoint_epoch,
                             fault.checkpoint_dir, fault.cause is exc, str(fault)))
            break
        except Exception as e:
            outcomes.append(("raised", type(e).__name__, e is exc))
            break
    return outcomes, None if manager is None else manager.saves, trainer.loads


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fault_fence_matches_gan_tpu(monkeypatch, name):
    """The same schedule through both fences: the epochs they rewind to, the
    exception each raises (a TrainingFault's epoch, checkpoint and message,
    or the original exception itself), the emergency saves, the states
    loaded. (A trainer whose state is unfetchable but whose restore works
    would part them: gan_tpu's restore reads the live state for its shapes
    before it reads the checkpoint, the port's needs none.)"""
    got = _drive(recovery.FaultFence, SCHEDULES[name], monkeypatch)
    want = _drive(jax_recovery.FaultFence, SCHEDULES[name], monkeypatch)
    assert got == want
    assert got[0], "the schedule ran no recover call"


def test_fence_goes_straight_to_the_emergency_exit_when_the_device_is_lost(monkeypatch):
    """A sticky fault: the probe of the device raises, so the fence neither
    restores nor fetches the state; it names the last periodic checkpoint
    and marks the fault ``device_lost``."""
    monkeypatch.setattr(recovery, "device_alive", lambda device: False)
    manager, trainer = _StubManager(2), _StubTrainer()
    trainer.state = lambda: pytest.fail("the fence fetched the state of a lost device")
    exc = torch.AcceleratorError("CUDA error: unspecified launch failure")
    with pytest.raises(recovery.TrainingFault) as info:
        recovery.FaultFence(trainer, manager).recover(3, exc)
    assert info.value.device_lost and info.value.cause is exc
    assert info.value.checkpoint_epoch == 2
    assert manager.saves == [] and manager.restores == 0 and trainer.loads == 0


def test_fence_makes_no_rewind_over_replicas():
    """At a world of 2 a rank cannot rewind alone: the rank with the manager
    writes its emergency snapshot, a rank without one writes nothing, and
    both raise TrainingFault."""
    for manager, saves in ((_StubManager(2), [3]), (None, None)):
        trainer = _StubTrainer()
        trainer.replicas = parallel.Replicas(rank=0 if manager else 1, size=2)
        with pytest.raises(recovery.TrainingFault) as info:
            recovery.FaultFence(trainer, manager).recover(3, RuntimeError("gloo: peer closed"))
        assert not info.value.device_lost
        assert (None if manager is None else manager.saves) == saves and trainer.loads == 0


# --------------------------------------------------------------------- CLIs

def _write_data(root, kind: str) -> list[str]:
    """PNGs for a CLI run (gan_tpu's test's shapes); returns the data flags.
    Pix2Pix: 10 pairs, 7 of them train (3 full steps and a 1-pair tail);
    CycleGAN: 9 X and 11 Y images, 6 and 9 of them train (3 full steps)."""
    rng = np.random.default_rng(7 if kind == "pix2pix" else 11)
    if kind == "pix2pix":
        data = root / "data"
        data.mkdir()
        for i in range(10):
            Image.fromarray(rng.integers(0, 255, (48, 96), np.uint8), "L").save(
                data / f"img_{i}.png")
        return ["--data", str(data)]
    for d, n in (("x", 9), ("y", 11)):
        (root / d).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (40, 40), np.uint8), "L").save(
                root / d / f"img_{i}.png")
    return ["--input-images", str(root / "x"), "--target-images", str(root / "y")]


def _argv(data: list[str], out, *extra) -> list[str]:
    return [*data, "--output", str(out), "--train", "--epochs", "6", "--img-size", "32",
            "--batch-size", "2", "--test-img", "2", "--logging", "false", "--dtype", "fp32",
            "--num-devices", "1", "--checkpoint-every", "2", *extra]


def _no_figs(train, val, prefix, output_path):
    """The loss figures as empty files: matplotlib's plots take seconds and
    hold nothing the fence changes."""
    os.makedirs(output_path, exist_ok=True)
    for k in train:
        open(os.path.join(output_path, f"{prefix}{k}.png"), "wb").close()


def _cli(kind: str, argv: list[str]) -> str:
    """Train through the port's CLI in this process; returns the run dir."""
    cli = pix2pix if kind == "pix2pix" else cycle_gan
    figs, cli.write_loss_figs = cli.write_loss_figs, _no_figs
    try:
        cli.main((parse_pix2pix if kind == "pix2pix" else parse_cyclegan)(argv))
    finally:
        cli.write_loss_figs = figs
    out = argv[argv.index("--output") + 1]
    (run,) = glob.glob(os.path.join(out, "*"))
    return run


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """``clean(kind)``: (data flags, the clean run's directory), made at its
    first call in this module (and worker), removed after the module."""
    runs, roots = {}, []

    def run(kind: str):
        if kind not in runs:
            roots.append(tmp_path_factory.mktemp(f"clean_{kind}"))
            data = _write_data(roots[-1], kind)
            runs[kind] = data, _cli(kind, _argv(data, roots[-1] / "out"))
        return runs[kind]

    yield run
    for root in roots:
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _drop_runs(tmp_path):
    """Each test's runs go when it ends: a CycleGAN checkpoint at 32² holds
    445 MB (two depth-5 U-Nets with 512 filters and their Adam moments)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _metrics(run: str) -> dict:
    with open(os.path.join(run, "logs", "train_metrics.json")) as f:
        return json.load(f)


def _pngs(run: str, sub: str) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(run, sub, "*.png"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _assert_same_run(run: str, want: str, metrics_from: int = 0) -> None:
    """``run`` equals ``want`` (from its epoch ``metrics_from`` on): train
    and val metrics, the sample and final PNGs byte for byte, the final
    checkpoint's tensors; and neither keeps an anchor checkpoint."""
    for name in ("train_metrics.json", "val_metrics.json"):
        with open(os.path.join(want, "logs", name)) as f:
            expected = {k: v[metrics_from:] for k, v in json.load(f).items()}
        with open(os.path.join(run, "logs", name)) as f:
            assert json.load(f) == expected, name
    for sub in ("test_images", "final_test_imgs"):
        if sub == "test_images" and metrics_from:
            continue   # a resumed run samples only the epochs it trained
        assert _pngs(run, sub) == _pngs(want, sub), sub
    assert _pngs(want, "final_test_imgs")
    ckpt = lambda r: CheckpointManager(os.path.join(r, "training_checkpoints"))
    assert ckpt(run).all_epochs() == ckpt(want).all_epochs()
    assert ckpt(run).latest_epoch() == 6 and 0 not in ckpt(run).all_epochs()
    got, expected = list(_leaves(ckpt(run).restore())), list(_leaves(ckpt(want).restore()))
    assert [p for p, _ in got] == [p for p, _ in expected]
    for (path, g), (_, w) in zip(got, expected):
        assert (torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w), path


class _Faults:
    """Tracks the train epochs that ``run_epoch`` starts (0-based over the
    train calls, re-runs included) and injects faults into them."""

    def __init__(self, monkeypatch, kind: str):
        self.train_calls, self.epochs, self.current = 0, [], None
        self.monkeypatch = monkeypatch
        cls = TRAINER[kind]
        real = cls.run_epoch
        self.at_entry = lambda call, epoch: None   # raises to fault at an epoch's entry
        faults = self

        def run_epoch(trainer, *args, training):
            if training:
                faults.current = faults.train_calls
                faults.epochs.append(args[-1])
                faults.train_calls += 1
                faults.at_entry(faults.current, args[-1])
            else:
                faults.current = None
            return real(trainer, *args, training=training)

        monkeypatch.setattr(cls, "run_epoch", run_epoch)

    def at_step(self, call: int, step: int, exc) -> None:
        """Raise ``exc`` once, after step ``step`` of train call ``call`` ran
        through the epoch runner (its update applied)."""
        real, faults, fired = loop.CachedEpoch._step, self, []

        def _step(runner):
            out = real(runner)
            if faults.current == call and not fired:
                faults.steps = getattr(faults, "steps", -1) + 1
                if faults.steps == step:
                    fired.append(True)
                    raise exc
            return out

        self.monkeypatch.setattr(loop.CachedEpoch, "_step", _step)


def _raise_at(calls, exc_kind):
    def at_entry(call, epoch):
        if call in calls:
            raise exc_kind(f"injected fault at train call {call} (epoch {epoch})")
    return at_entry


@pytest.mark.parametrize("kind", KINDS)
def test_fault_at_an_epoch_entry_rewinds_to_the_clean_run(tmp_path, monkeypatch, capsys, clean,
                                                         kind):
    """A fault as the 4th train epoch starts: the fence rewinds to the
    --checkpoint-every save at epoch 2 and re-runs epochs 3 and 4."""
    data, want = clean(kind)
    faults = _Faults(monkeypatch, kind)
    faults.at_entry = _raise_at({3}, RuntimeError)
    run = _cli(kind, _argv(data, tmp_path / "out"))
    assert faults.epochs == [0, 1, 2, 3, 2, 3, 4, 5]
    assert "[recovery] rewound to checkpoint at epoch 2" in capsys.readouterr().out
    _assert_same_run(run, want)


@pytest.mark.parametrize("kind", KINDS)
def test_fault_inside_an_epoch_after_an_update_rewinds_to_the_clean_run(tmp_path, monkeypatch,
                                                                       capsys, clean, kind):
    """A fault after the 2nd step of the 4th train epoch, whose update has
    changed the parameters in place: the restore replaces them, and the
    re-run equals the clean run."""
    data, want = clean(kind)
    faults = _Faults(monkeypatch, kind)
    faults.at_step(3, 1, RuntimeError("injected fault after a step"))
    run = _cli(kind, _argv(data, tmp_path / "out"))
    assert faults.epochs == [0, 1, 2, 3, 2, 3, 4, 5]
    assert "[recovery] rewound to checkpoint at epoch 2" in capsys.readouterr().out
    _assert_same_run(run, want)


@pytest.mark.parametrize("kind", KINDS)
def test_transient_os_error_in_a_streamed_epoch_rewinds_and_ends_its_threads(
        tmp_path, monkeypatch, capsys, clean, kind):
    """``--host-cache off``: a decode of the 4th train epoch raises OSError
    once, on a producer thread. The epoch ends every thread it started
    before the re-run begins, and the run equals the clean one (a streamed
    run equals the resident run bit for bit)."""
    data, want = clean(kind)
    faults = _Faults(monkeypatch, kind)
    real_rows, armed = pipeline.Rows.__call__, []

    def rows(self, paths, out=None):
        if armed:
            armed.clear()
            raise OSError("injected transient read error")
        return real_rows(self, paths, out)

    monkeypatch.setattr(pipeline.Rows, "__call__", rows)
    before = set(threading.enumerate())
    alive_at_entry = {}

    def at_entry(call, epoch):
        alive_at_entry[call] = set(threading.enumerate()) - before
        if call == 3:
            armed.append(True)

    faults.at_entry = at_entry
    run = _cli(kind, _argv(data, tmp_path / "out", "--host-cache", "off"))
    assert faults.epochs == [0, 1, 2, 3, 2, 3, 4, 5]
    assert "OSError: injected transient read error" in capsys.readouterr().out
    assert alive_at_entry[4] == set(), alive_at_entry   # the re-run's first epoch
    assert set(threading.enumerate()) == before
    _assert_same_run(run, want)


def test_a_failing_file_ends_both_cyclegan_streams_while_the_fault_is_held(tmp_path):
    """A CycleGAN epoch from two FileCaches of 20 files, the third X file cut
    short: ``run_epoch`` raises OSError naming it, and while the exception
    and its traceback are still held, no thread of the epoch is alive: the
    Y stream's FileCache is closed with the zip of both
    (``loader.zip_closing``), not when the traceback lets it go."""
    rng = np.random.default_rng(3)
    paths = {}
    for d, n in (("x", 20), ("y", 20)):   # 10 steps: Y's producer waits on its full queue
        (tmp_path / d).mkdir()
        paths[d] = []
        for i in range(n):
            paths[d].append(str(tmp_path / d / f"{i}.png"))
            Image.fromarray(rng.integers(0, 255, (40, 36), np.uint8), "L").save(paths[d][-1])
    with open(paths["x"][2], "rb") as f:
        head = f.read(100)
    with open(paths["x"][2], "wb") as f:
        f.write(head)
    rows = pipeline.cyclegan_rows(img_size=32, channels=1, train=True)
    x, y = (FileCache(paths[d], rows, 2) for d in ("x", "y"))
    trainer = CycleGANTrainer(parse_cyclegan(
        ["--input-images", "x", "--target-images", "y", "--output", "o", "--train", "--epochs",
         "1", "--img-size", "32", "--batch-size", "2", "--dtype", "fp32", "--buffer-size", "1"]))
    before = set(threading.enumerate())
    with pytest.raises(OSError, match=re.escape(paths["x"][2])) as info:
        trainer.run_epoch(x, y, 0, training=True)
    assert info.value.__traceback__ is not None
    assert set(threading.enumerate()) == before


def test_fault_storm_exits_17_resume_ready_and_resume_finishes(tmp_path, monkeypatch, capsys,
                                                              clean):
    """Every train epoch from the 3rd faults: 3 rewinds to epoch 2, then
    exit 17 with the resume line and checkpoint 2 in place; ``--resume``
    trains the remaining 4 epochs, equal to the clean run's."""
    data, want = clean("pix2pix")
    faults = _Faults(monkeypatch, "pix2pix")
    faults.at_entry = _raise_at(range(2, 99), RuntimeError)
    with pytest.raises(SystemExit) as info:
        _cli("pix2pix", _argv(data, tmp_path / "out"))
    assert info.value.code == recovery.EXIT_CODE
    (run,) = glob.glob(str(tmp_path / "out" / "*"))
    out = capsys.readouterr().out
    assert out.count("[recovery] rewound to checkpoint at epoch 2") == 3
    assert f"{RESUME_LINE}{run}" in out
    assert CheckpointManager(os.path.join(run, "training_checkpoints")).all_epochs() == [2]
    monkeypatch.undo()
    resumed = _cli("pix2pix", _argv(data, tmp_path / "resumed", "--resume", run))
    assert all(len(v) == 4 for v in _metrics(resumed).values())
    _assert_same_run(resumed, want, metrics_from=2)


@pytest.mark.parametrize("case", ["value_error", "file_not_found", "retries_off"])
def test_errors_that_are_not_rewound_propagate_unchanged(tmp_path, monkeypatch, capsys, case):
    """A ValueError and a FileNotFoundError in the 2nd train epoch, and a
    fault under ``GAN_TPU_FAULT_RETRIES=0``, leave ``fit`` as they were
    raised: no rewind, no restore, no emergency save."""
    data = _write_data(tmp_path, "pix2pix")
    kind = {"value_error": ValueError, "file_not_found": FileNotFoundError,
            "retries_off": RuntimeError}[case]
    if case == "retries_off":
        monkeypatch.setenv("GAN_TPU_FAULT_RETRIES", "0")
    raised = []

    def at_entry(call, epoch):
        if call == 1:
            raised.append(kind(f"injected {case}"))
            raise raised[0]

    faults = _Faults(monkeypatch, "pix2pix")
    faults.at_entry = at_entry
    restores = []
    monkeypatch.setattr(CheckpointManager, "restore",
                        lambda self, *a, **kw: restores.append(1))
    with pytest.raises(kind) as info:
        _cli("pix2pix", _argv(data, tmp_path / "out"))
    assert info.value is raised[0]
    assert "[recovery]" not in capsys.readouterr().out
    (run,) = glob.glob(str(tmp_path / "out" / "*"))
    assert restores == []
    # the anchor only: the first epoch saved nothing, and no emergency save
    assert CheckpointManager(os.path.join(run, "training_checkpoints")).all_epochs() == [0]


def test_two_gloo_ranks_with_a_fault_on_rank_1_exit_17(tmp_path):
    """``--num-devices 2`` through ``parallel.launch``, rank 1 faulting as its
    2nd train epoch starts (``torch_dist_worker.fault_on_rank_1``): no rank
    rewinds, rank 1 prints the resume line, the parent ends rank 0 and exits
    17, all within the time limit."""
    data = _write_data(tmp_path, "pix2pix")
    argv = _argv(data, tmp_path / "out", "--num-devices", "2")
    argv[argv.index("--batch-size") + 1] = "4"
    env = dict(os.environ, GAN_TPU_PLATFORM="cpu", GAN_TPU_ALLOW_ANY_SIZE="1",
               PYTHONPATH=os.pathsep.join([REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c",
                           f"import torch_dist_worker as w; w.fault_main({argv!r})"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == recovery.EXIT_CODE, out[-4000:]
    (run,) = glob.glob(str(tmp_path / "out" / "*"))
    assert f"{RESUME_LINE}{run}" in out and "injected fault on rank 1" in out
    assert "rewound to checkpoint" not in out
