"""The device-side epoch, shuffles and batch counts (counterpart of
gan_tpu/train/loop.py: ``make_cached_epoch``, ``epoch_rng``, ``epoch_perm``,
``epoch_plan``, and the data-parallel ``stripe_order``, ``local_perm`` and
``shuffled_stripe_perm``).

gan_tpu compiles one program per epoch: a ``scan`` of the step over a
device-resident cache. Here :func:`make_cached_epoch` builds a
:class:`CachedEpoch` from a step written against static inputs (the uint8
caches, a static index buffer, static draw buffers). On the card the first
step it runs is captured into a ``torch.cuda.CUDAGraph``, and every later
step replays that graph: the host only writes the step's indices and draws
into the static buffers and launches the replay, with no synchronisation,
and the losses are fetched once per epoch. On the CPU the same step runs
eagerly, step by step. Capture or replay failures raise; nothing falls back
to an eager step on the card. A streamed epoch runs the same runner over
:class:`StreamBuffers`, device buffers of one batch that ``prepare`` fills
from the host before each step.

Data parallelism (gan_tpu_torch.parallel): a resident cache is striped over
the W replicas, row i on rank i % W at local index i // W, so that a
fixed-order global step s takes exactly rows [s·B, (s+1)·B) at any W
(``local_perm``), and a shuffled epoch draws each stripe's own order
(``shuffled_stripe_perm``). Under NCCL the captured step holds the step's
all-reduces; the runner's eager warm-up step is then also the group's first
collective, which NCCL needs before a capture. A gloo group's collectives
run on the host and cannot be captured, so with one the runner runs every
step eagerly on the card, by that rule (``capture=False``), and counts them.

While the profiler records, each step opens a span of
``gan_tpu_torch.utils.profiling`` on the host: ``runner.replay``,
``step.eager``, or ``runner.capture`` around the capture, from outside it,
so that nothing inside the captured step records a range the replays would
not; ``StreamBuffers.load`` opens ``data.h2d``.

The port keeps its own copy of the numpy part because gan_tpu's module
imports jax.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import numpy as np
import torch

from gan_tpu_torch.utils.profiling import COUNTERS, span


def epoch_rng(seed: int, epoch: int, stream: int = 0) -> np.random.Generator:
    """Host RNG for one epoch's shuffle draws, a pure function of (seed,
    epoch, stream), so a re-run of an epoch draws the same orders. ``stream``
    separates the train (0) and val (1) draws."""
    return np.random.default_rng(np.random.SeedSequence([seed % (2**32), epoch, stream]))


def epoch_perm(n: int, buffer_size: int, rng: np.random.Generator) -> np.ndarray:
    """Epoch order honoring ``--buffer-size``: tf.data's windowed shuffle (a
    buffer of ``buffer_size`` elements, each output drawn uniformly from it
    and replaced by the next stream element). At buffer_size >= n it is a
    full uniform permutation."""
    if buffer_size >= n:
        return rng.permutation(n)
    b = min(buffer_size, n)
    buf = np.arange(b)
    out = np.empty(n, np.int64)
    # the draw bounds are known ahead (b while the stream refills the buffer,
    # then b-1, ..., 1 as it drains), so all draws are made in one call; the
    # buffer chase is sequential
    ends = np.concatenate([np.full(n - b, b, np.int64), np.arange(b, 0, -1)])
    js = rng.integers(0, ends)
    nxt = b
    for i in range(n - b):
        j = js[i]
        out[i] = buf[j]
        buf[j] = nxt
        nxt += 1
    for i in range(n - b, n):
        j = js[i]
        out[i] = buf[j]
        buf[j] = buf[ends[i] - 1]
    return out


def epoch_plan(n: int, batch_size: int, ndev: int = 1) -> tuple[int, int]:
    """(full global batches, size of the partial last batch) of ``n`` rows;
    tf.data batches without dropping the remainder. Over ``ndev`` replicas
    each full batch splits into ``batch_size // ndev`` rows per replica, and
    the partial batch runs whole on every replica (gan_tpu's ``epoch_plan``,
    whose per-device batch the trainers keep as ``local_batch``)."""
    if batch_size % ndev:
        raise ValueError(f"global batch {batch_size} must divide across {ndev} devices")
    return n // batch_size, n % batch_size


def stripe_order(n: int, ndev: int) -> np.ndarray:
    """The row order that, cut into ``ndev`` equal blocks, puts row i in block
    i % ndev at index i // ndev: block d is [d, d + ndev, d + 2·ndev, ...].
    Rows past n (padding to equal blocks) wrap to the start of that block's
    stripe; no epoch draws them."""
    l = -(-max(n, 1) // ndev)
    rows = np.arange(ndev)[:, None] + np.arange(l)[None, :] * ndev
    return np.where(rows < max(n, 1), rows, rows % max(n, 1)).reshape(-1)


def _stripe_len(n: int, ndev: int, d: int, need: int) -> int:
    real = n // ndev + (1 if d < n % ndev else 0)
    if need > max(real, 1):
        raise ValueError(f"need {need} rows from a {real}-row stripe (n={n}, ndev={ndev})")
    return real


def local_perm(n: int, *, ndev: int, n_steps: int, per_dev_batch: int) -> np.ndarray:
    """(n_steps, ndev · per_dev_batch) int32 local indices of a fixed-order
    epoch over a striped cache: column block d indexes stripe d, and every
    block is ``arange``, so global step s draws exactly rows [s·B, (s+1)·B)
    at any ndev (Pix2Pix's fixed order, which the reference shuffles once
    at the split)."""
    need = n_steps * per_dev_batch
    cols = []
    for d in range(ndev):
        _stripe_len(n, ndev, d, need)
        cols.append(np.arange(need).reshape(n_steps, per_dev_batch))
    return np.concatenate(cols, axis=1).astype(np.int32)


def shuffled_stripe_perm(n: int, *, ndev: int, n_steps: int, per_dev_batch: int,
                         buffer_size: int, rng: np.random.Generator
                         ) -> tuple[np.ndarray, np.ndarray]:
    """A shuffled epoch over a striped cache (CycleGAN's per-epoch shuffles
    over ndev > 1 replicas): ``perm``, (n_steps, ndev · per_dev_batch) local
    indices as in :func:`local_perm`, each stripe's order drawn by
    :func:`epoch_perm` over that stripe (``--buffer-size`` per stripe), and
    ``leftover``, the global rows (stripe d, local j ↔ j·ndev + d) that the
    full steps did not draw, shuffled across stripes. The zip tail draws
    from ``leftover``, so an epoch visits every row at most once, and the
    shorter domain exactly once."""
    need = n_steps * per_dev_batch
    cols, leftovers = [], []
    for d in range(ndev):
        real = _stripe_len(n, ndev, d, need)
        order = epoch_perm(max(real, 1), buffer_size, rng)
        cols.append(order[:need].reshape(n_steps, per_dev_batch))
        leftovers.append(order[need:real].astype(np.int64) * ndev + d)
    perm = np.concatenate(cols, axis=1).astype(np.int32)
    leftover = np.concatenate(leftovers) if leftovers else np.empty(0, np.int64)
    rng.shuffle(leftover)   # unbias the tail's draw across the stripes
    return perm, leftover


class CachedEpoch:
    """Runs ``step_fn`` once per step of an epoch (see :func:`make_cached_epoch`).

    On the card, the first step is the capture's warm-up: it runs eagerly on
    a side stream, as capturing an autograd backward requires, and it is a
    real step (it trains once, so the optimizers take exactly one update per
    step and their state exists before capture). The same step is then
    captured, and every later step, in this epoch and the next ones,
    replays the graph. ``counts`` tallies the steps run eagerly, the
    captures and the replays. With ``capture=False`` (a gloo group's
    collectives in the step) every step on the card runs eagerly, and
    ``counts["eager_by_backend"]`` counts those steps too."""

    def __init__(self, step_fn: Callable[[], torch.Tensor], device: torch.device, *,
                 counts: dict, pool=None, capture: bool = True):
        self.step_fn = step_fn
        self.device = device
        self.pool = pool
        self.capture = capture
        self.counts = counts   # {"eager", "captures", "replays"}: shared tallies
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None   # the graph's losses, rewritten by each replay
        self.capture_s = 0.0   # host seconds the capture took

    def __call__(self, n_steps: int, prepare: Callable[[int], None]) -> torch.Tensor:
        """(n_steps, K) losses on the device. ``prepare(s)`` writes step s's
        inputs into the static buffers; it runs on the current stream before
        the step, so the host never waits for the device."""
        losses = None
        for s in range(n_steps):
            prepare(s)
            out = self._step()
            if losses is None:
                losses = torch.empty((n_steps, *out.shape), dtype=out.dtype, device=out.device)
            losses[s].copy_(out)
        return losses

    def _step(self) -> torch.Tensor:
        if self.device.type != "cuda" or not self.capture:
            self.counts["eager"] += 1
            if self.device.type == "cuda":
                self.counts["eager_by_backend"] += 1
            with span("gan_tpu_torch.step.eager"):
                return self.step_fn()
        if self.graph is None:
            return self._warm_up_and_capture()
        try:
            with span("gan_tpu_torch.runner.replay"):
                self.graph.replay()
        except RuntimeError as err:
            raise RuntimeError(f"replaying the captured epoch step failed: {err}") from err
        self.counts["replays"] += 1
        return self._out

    def _warm_up_and_capture(self) -> torch.Tensor:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), span("gan_tpu_torch.step.eager"):
            losses = self.step_fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.counts["eager"] += 1
        # the warm-up's freed blocks stay cached in the default pool, and the
        # allocator may not free them while a capture is under way: where they
        # outgrow what is left on the card (a step of more than half of it),
        # the capture would run out of memory, so they are freed first
        cached = torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        if cached > torch.cuda.mem_get_info(self.device)[0]:
            torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no garbage collection inside the capture: a collected graph's
        # destructor would call the CUDA runtime, which the capture forbids
        collecting = gc.isenabled()
        gc.disable()
        stream = torch.cuda.current_stream(self.device)
        try:
            with span("gan_tpu_torch.runner.capture"), torch.cuda.graph(graph, pool=self.pool):
                out = self.step_fn()
        except RuntimeError as err:
            # where ending the capture raises, torch.cuda.graph leaves its
            # capture stream current: the re-run of a rewind starts on ours
            torch.cuda.set_stream(stream)
            raise RuntimeError(f"capturing the epoch step into a CUDA graph failed: {err}") from err
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        COUNTERS.add("runner.capture_seconds", self.capture_s)
        self.graph, self._out = graph, out
        self.counts["captures"] += 1
        return losses


class StreamBuffers:
    """The static inputs of a streamed epoch's runner: one device buffer of
    B rows per domain, which the runner's step reads as its "cache" (its
    index buffers hold ``arange(B)``), and the pinned host slots that feed
    them.

    :meth:`load` runs on the main thread, in ``prepare``, before each step:
    it copies the host batch into a pinned slot and enqueues the slot's
    host-to-device copy into the buffers on the current stream, where the
    step runs, so stream order keeps batch s + 1 from overwriting the
    buffers while step s reads them. A slot is written again only after its
    last copy's event has completed, ``SLOTS`` batches later, which bounds
    the host's lead without synchronising each step. The producer threads
    only make numpy batches: they never touch a slot and make no CUDA call,
    so a graph capture on the main thread cannot meet one of theirs. The
    slots and buffers are allocated once, before the first capture, and
    kept across epochs, so the runner keyed by the buffers' addresses is
    captured once. On the CPU the batch is copied straight into the buffers.
    """

    SLOTS = 3

    def __init__(self, shapes, device: torch.device):
        self.device = device
        self.buffers = tuple(torch.empty(s, dtype=torch.uint8, device=device) for s in shapes)
        self.slots, self.copied = [], []
        if device.type == "cuda":
            self.slots = [tuple(torch.empty(s, dtype=torch.uint8, pin_memory=True) for s in shapes)
                          for _ in range(self.SLOTS)]
            self.copied = [torch.cuda.Event() for _ in range(self.SLOTS)]
        self.loads = 0

    def load(self, arrays) -> None:
        """Copy one host batch, a uint8 array per domain, into the buffers."""
        with span("gan_tpu_torch.data.h2d"):
            if self.device.type != "cuda":
                for buf, a in zip(self.buffers, arrays):
                    buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
                return
            k = self.loads % self.SLOTS
            self.loads += 1
            self.copied[k].synchronize()   # its copy of SLOTS batches ago; no-op before the first
            for slot, buf, a in zip(self.slots[k], self.buffers, arrays):
                np.copyto(slot.numpy(), a)
                buf.copy_(slot, non_blocking=True)
            self.copied[k].record()


def make_cached_epoch(step_fn: Callable[[], torch.Tensor], device: torch.device, *,
                      counts: dict, pool=None, capture: bool = True) -> CachedEpoch:
    """The epoch runner of ``step_fn`` (gan_tpu/train/loop.py:63).

    ``step_fn()`` runs one step against static inputs (the caches, the index
    and draw buffers, which ``prepare`` fills before each step) and returns
    its (K,) losses; it takes no host values and makes no host
    synchronisation, so that it can be captured. ``counts`` tallies the
    steps run eagerly, the captures and the replays. ``pool`` is the graph
    memory pool (``torch.cuda.graph_pool_handle()``) that runners which
    never run at once may share. ``capture=False`` runs every step eagerly
    on the card as well (a step with collectives that cannot be captured)."""
    return CachedEpoch(step_fn, device, pool=pool, counts=counts, capture=capture)
