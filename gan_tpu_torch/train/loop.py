"""The device-side epoch, shuffles and batch counts (counterpart of
gan_tpu/train/loop.py: ``make_cached_epoch``, ``epoch_rng``, ``epoch_perm``,
``epoch_plan``).

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

The port keeps its own copy of the numpy part because gan_tpu's module
imports jax.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import numpy as np
import torch


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


def epoch_plan(n: int, batch_size: int) -> tuple[int, int]:
    """(full batches, size of the partial last batch) of ``n`` rows; tf.data
    batches without dropping the remainder."""
    return n // batch_size, n % batch_size


class CachedEpoch:
    """Runs ``step_fn`` once per step of an epoch (see :func:`make_cached_epoch`).

    On the card, the first step is the capture's warm-up: it runs eagerly on
    a side stream, as capturing an autograd backward requires, and it is a
    real step (it trains once, so the optimizers take exactly one update per
    step and their state exists before capture). The same step is then
    captured, and every later step, in this epoch and the next ones,
    replays the graph. ``counts`` tallies the steps run eagerly, the
    captures and the replays."""

    def __init__(self, step_fn: Callable[[], torch.Tensor], device: torch.device, *,
                 counts: dict, pool=None):
        self.step_fn = step_fn
        self.device = device
        self.pool = pool
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
        if self.device.type != "cuda":
            self.counts["eager"] += 1
            return self.step_fn()
        if self.graph is None:
            return self._warm_up_and_capture()
        try:
            self.graph.replay()
        except RuntimeError as err:
            raise RuntimeError(f"replaying the captured epoch step failed: {err}") from err
        self.counts["replays"] += 1
        return self._out

    def _warm_up_and_capture(self) -> torch.Tensor:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
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
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.step_fn()
        except RuntimeError as err:
            raise RuntimeError(f"capturing the epoch step into a CUDA graph failed: {err}") from err
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
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
                      counts: dict, pool=None) -> CachedEpoch:
    """The epoch runner of ``step_fn`` (gan_tpu/train/loop.py:63).

    ``step_fn()`` runs one step against static inputs (the caches, the index
    and draw buffers, which ``prepare`` fills before each step) and returns
    its (K,) losses; it takes no host values and makes no host
    synchronisation, so that it can be captured. ``counts`` tallies the
    steps run eagerly, the captures and the replays. ``pool`` is the graph
    memory pool (``torch.cuda.graph_pool_handle()``) that runners which
    never run at once may share."""
    return CachedEpoch(step_fn, device, pool=pool, counts=counts)
