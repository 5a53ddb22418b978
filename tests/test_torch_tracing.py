"""The port's spans and counters (``gan_tpu_torch/utils/profiling.py``).

On the CPU (32², batch 2, fp32): with the profiler off ``span`` is a shared
no-op that never reaches ``record_function``; under ``torch.profiler`` a
resident pass with a partial tail and a pass streamed from FileCaches open
the spans of ``SPANS`` where the runner, the trainers and the stream open
them, each inside its pass's ``gan_tpu_torch.epoch``; ``COUNTERS`` counts
every decoded file, also from two producers at once, and holds its sums
under threads; ``fit``'s ``[perf]`` line keeps its rate where
``chip_smoke.perf_rate`` reads it and carries the epoch's counters. On the
card (``-m cuda``: 64², bf16) a traced first epoch records the capture from
outside it, no program span inside it, and its replays still equal the
eager step. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gan_tpu_torch.train import base, loop
from gan_tpu_torch.utils.profiling import COUNTERS, SPANS, Counters, span
from test_torch_epoch import (TRAINERS, _assert_close_losses, _caches, _fit_with_stub_epochs,
                              _old_epoch, _trainer, cuda_trainers)  # noqa: F401 (a fixture)
from test_torch_streaming import _groups, _sets
from torch_inputs import limit_threads

limit_threads()


def _program_spans(prof) -> list[tuple[str, float, float]]:
    """(name, start µs, end µs) of the program's spans in a profile, by start."""
    spans = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gan_tpu_torch.")
             and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(spans, key=lambda s: s[1])


def _count(spans, short: str) -> int:
    return sum(name == "gan_tpu_torch." + short for name, _a, _b in spans)


def test_span_is_a_shared_no_op_while_the_profiler_is_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    shared = span(SPANS[0])
    assert all(span(name) is shared for name in SPANS)
    with span("gan_tpu_torch.epoch"):
        pass


def test_span_under_the_profiler_names_only_listed_spans():
    assert len(set(SPANS)) == len(SPANS) and all(n.startswith("gan_tpu_torch.") for n in SPANS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in SPANS:
            with span(name):
                pass
        with pytest.raises(ValueError, match="not one of"):
            span("gan_tpu_torch.unlisted")
    assert [name for name, _a, _b in _program_spans(prof)] == list(SPANS)


class _Counted:
    """An iterator that counts its ``next()`` calls (the stream's waits)."""

    def __init__(self, it):
        self.it, self.calls = it, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.calls += 1
        return next(self.it)

    def close(self):
        self.it.close()


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("source", ["resident", "files"])
@pytest.mark.parametrize("kind", TRAINERS)
def test_a_traced_pass_opens_the_spans_where_the_runner_and_the_stream_do(
        monkeypatch, tmp_path, kind, source, training):
    """One pass under the profiler, with a partial tail but for CycleGAN's
    resident val pass (CycleGAN train: a zip tail): one ``epoch``,
    ``epoch.plan`` and ``epoch.fetch``; a ``runner.prepare`` a full step;
    ``step.eager`` for each step the runner ran eagerly and for the tail;
    streamed, a ``data.wait`` for each ``next()`` on the prefetch queue and
    a ``data.h2d`` a full step; every other span inside ``epoch``."""
    trainer = _trainer(kind)
    if source == "resident":
        caches = _caches(kind, 32, trainer.device)[1 - training]
    else:
        sets, rows = _sets(tmp_path, kind)
        caches = _groups(kind, sets, rows, "files")[1 - training]
    full, tail = loop.epoch_plan(min(c.shape[0] for c in caches), trainer.config.batch_size)
    tails = int(tail > 0)
    queues = []
    real_prefetch = base.loader.prefetch_iter
    monkeypatch.setattr(base.loader, "prefetch_iter",
                        lambda it, depth: queues.append(_Counted(real_prefetch(it, depth)))
                        or queues[-1])
    eager = trainer.epoch_counts["eager"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        losses = trainer.run_epoch(*caches, 0, training=training)
    assert len(losses) == full + tails and full
    spans = _program_spans(prof)
    assert {name for name, _a, _b in spans} <= set(SPANS)
    assert [_count(spans, s) for s in ("epoch", "epoch.plan", "epoch.fetch")] == [1, 1, 1]
    assert _count(spans, "runner.prepare") == full
    assert _count(spans, "step.eager") == trainer.epoch_counts["eager"] - eager + tails
    assert _count(spans, "runner.replay") == _count(spans, "runner.capture") == 0
    waits = queues[0].calls if source == "files" else 0
    assert len(queues) == (source == "files") and waits == (full + tails) * len(queues)
    assert _count(spans, "data.wait") == waits
    assert _count(spans, "data.h2d") == (full if source == "files" else 0)
    (_, start, end), = [s for s in spans if s[0] == "gan_tpu_torch.epoch"]
    assert all(start <= a <= b <= end for _name, a, b in spans)


@pytest.mark.parametrize("kind", TRAINERS)
def test_decode_counters_count_every_file_the_file_caches_decode(tmp_path, kind):
    """A streamed train pass: ``decode.files`` grows by the rows that the
    FileCaches' ``rows`` calls returned (CycleGAN: two producers at once, X
    and Y), ``decode.seconds`` and the stream's waits by what was spent."""
    sets, rows = _sets(tmp_path, kind)
    decoded, lock = [], threading.Lock()

    def counting(split):
        def decode(paths):
            out = split(paths)
            with lock:
                decoded.append(len(out))
            return out
        decode.shape = split.shape
        return decode

    caches = _groups(kind, sets, lambda train: counting(rows(train)), "files")[0]
    before = COUNTERS.snapshot()
    _trainer(kind).run_epoch(*caches, 0, training=True)
    after = COUNTERS.snapshot()
    d = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert len(decoded) == (4 if kind == "cyclegan" else 3)
    assert d["decode.files"] == sum(decoded) > 0 and d["decode.seconds"] > 0
    assert d["data.waits"] == 3 - (kind == "cyclegan") and d["data.wait_seconds"] >= 0


def test_counters_hold_their_sums_under_threads():
    """More adding threads than cores, switching as often as the
    interpreter allows: no add is lost."""
    counters, threads, adds = Counters(), 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [counters.add("n", 1) for _ in range(adds)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert counters.snapshot() == {"n": threads * adds}


@pytest.mark.parametrize("kind", TRAINERS)
def test_perf_line_keeps_its_rate_and_carries_the_epoch_counters(monkeypatch, tmp_path,
                                                                capsys, kind):
    """Under ``GAN_TPU_PERF=1`` each train epoch's line starts as it did,
    so ``chip_smoke.perf_rate`` reads its rate, and then gives that epoch's
    own data wait, decode rate, eager steps, captures, replays and capture
    seconds."""
    import chip_smoke

    monkeypatch.setenv("GAN_TPU_PERF", "1")
    monkeypatch.delenv("GAN_TPU_PROFILE_DIR", raising=False)
    trainer = _trainer(kind)

    def on_epoch(epoch, training):
        if training:
            COUNTERS.add("data.wait_seconds", 0.25)
            COUNTERS.add("data.waits", 5)
            COUNTERS.add("decode.files", 8 * (epoch + 1))
            COUNTERS.add("decode.seconds", 0.5)
            COUNTERS.add("runner.capture_seconds", 1.5 if epoch == 0 else 0.0)
            trainer.epoch_counts["eager"] += epoch == 0
            trainer.epoch_counts["captures"] += epoch == 0
            trainer.epoch_counts["replays"] += 3

    _fit_with_stub_epochs(trainer, tmp_path, on_epoch=on_epoch)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[perf]")]
    unit = "image-pairs" if kind == "cyclegan" else "images"
    assert len(lines) == 4
    for epoch, line in enumerate(lines):
        head, tail = line.split("; ")
        rate = float(head.split(": ")[1].split()[0])
        assert head == f"[perf] epoch {epoch + 1}: {rate:.1f} {unit}/sec ({rate:.1f}/chip)"
        assert tail == (f"data wait 0.250 s in 5 waits, decode {16.0 * (epoch + 1):.1f} files/s, "
                        f"eager {int(epoch == 0)}, captures {int(epoch == 0)}, replays 3, "
                        f"capture {1.5 if epoch == 0 else 0.0:.2f} s")
    assert chip_smoke.perf_rate("\n".join(lines)) == float(lines[-1].split(": ")[1].split()[0])


# ------------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("kind", TRAINERS)
def test_a_traced_first_epoch_records_the_capture_from_outside(cuda_trainers, kind):
    """The first train epoch under the profiler (CPU and CUDA): one
    ``runner.capture`` after the warm-up's ``step.eager``, no program span
    opened inside it, a replay a later full step; then the graph epoch and
    the next one equal the eager step from the same state, as untraced."""
    graph, eager = cuda_trainers(kind), cuda_trainers(kind)
    train, _ = _caches(kind, 64, graph.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = graph.run_epoch(*train, 0, training=True)
    spans = _program_spans(prof)
    (_, c0, c1), = [s for s in spans if s[0] == "gan_tpu_torch.runner.capture"]
    assert not [s for s in spans if c0 < s[1] < c1]
    warm_up = [s for s in spans if s[0] == "gan_tpu_torch.step.eager" and s[2] <= c0]
    assert len(warm_up) == 1
    full, tail = loop.epoch_plan(min(c.shape[0] for c in train), graph.config.batch_size)
    assert _count(spans, "runner.replay") == full - 1 == graph.epoch_counts["replays"]
    assert _count(spans, "step.eager") == 1 + (tail > 0)
    _assert_close_losses(got, _old_epoch(eager, train, 0, True), f"{kind} traced epoch 0")
    _assert_close_losses(graph.run_epoch(*train, 1, training=True),
                         _old_epoch(eager, train, 1, True), f"{kind} epoch 1")


def _pix2pixhd_trainer(device=None):
    from gan_tpu_torch.config import Pix2PixHDConfig
    from gan_tpu_torch.parallel import Replicas
    from gan_tpu_torch.train.pix2pixhd_trainer import Pix2PixHDTrainer
    cfg = Pix2PixHDConfig(ngf=8, n_downsample_global=2, n_blocks_global=2, ndf=16,
                          batch_size=2, dtype="fp32" if device is None else "bf16",
                          load_size=64, no_vgg_loss=True)
    return Pix2PixHDTrainer(cfg, None if device is None else Replicas(device=device))


def _hd_rows(n, device=None):
    rows = torch.randint(0, 256, (n, 32, 64, 6), generator=torch.Generator().manual_seed(1),
                         dtype=torch.uint8)
    rows[..., 0] %= 35
    return rows if device is None else rows.to(device)


@pytest.mark.parametrize("training", [True, False])
def test_a_traced_pix2pixhd_pass_opens_the_runners_spans(training):
    """pix2pixHD's trainer reaches the card only through the shared runner:
    a traced resident pass of 5 rows at batch 2 opens one ``epoch``,
    ``epoch.plan`` and ``epoch.fetch``, a ``runner.prepare`` a full step, a
    ``step.eager`` for each eager step and the tail, every span inside
    ``epoch`` and named in ``SPANS``."""
    trainer = _pix2pixhd_trainer()
    eager = trainer.epoch_counts["eager"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        losses = trainer.run_epoch(_hd_rows(5), 0, training=training)
    assert losses.shape == (3, 5)
    spans = _program_spans(prof)
    assert {name for name, _a, _b in spans} <= set(SPANS)
    assert [_count(spans, s) for s in ("epoch", "epoch.plan", "epoch.fetch")] == [1, 1, 1]
    assert _count(spans, "runner.prepare") == 2
    assert _count(spans, "step.eager") == trainer.epoch_counts["eager"] - eager + 1
    (_, start, end), = [s for s in spans if s[0] == "gan_tpu_torch.epoch"]
    assert all(start <= a <= b <= end for _name, a, b in spans)


@pytest.mark.cuda
def test_a_traced_pix2pixhd_epoch_records_its_capture_from_outside():
    """On the card the first train pass warms up eagerly, captures once
    (``runner.capture``, counted in ``runner.capture_seconds``) with no
    program span inside, and replays every later full step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    device = torch.device("cuda")
    trainer = _pix2pixhd_trainer(device)
    before = COUNTERS.snapshot().get("runner.capture_seconds", 0.0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_epoch(_hd_rows(9, device), 0, training=True)
    spans = _program_spans(prof)
    (_, c0, c1), = [s for s in spans if s[0] == "gan_tpu_torch.runner.capture"]
    assert not [s for s in spans if c0 < s[1] < c1]
    assert _count(spans, "runner.replay") == 3 == trainer.epoch_counts["replays"]   # 4 full steps
    assert COUNTERS.snapshot()["runner.capture_seconds"] > before
