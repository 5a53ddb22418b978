"""What the Pix2Pix and CycleGAN trainers share.

``GANTrainer`` holds the networks, one Adam per network and the draws. A
subclass builds its networks, declares its gradient groups (``groups``:
tuples of network names) and writes ``_losses(x, y, generators)``, which
returns (one objective per group, the stacked metrics). The step is then
common: each group takes one ``torch.autograd.grad`` of its objective with
respect to all of its networks' parameters, one graph task that walks each
node of the forward once, and all gradients are taken before any network is
updated. A group's objective must give each of its networks the gradient of
that network's own total (the reference's one tape per network, gan_tpu's
``sg_tree`` partition of one combined scalar): a network alone in its group
takes its total, and a group of several takes a sum whose every term
reaches each network as that network's total would (the CycleGAN trainer's
module docstring gives its argument).

Draws come from ``torch.Generator``s seeded as a pure function of a key
(``_draws``), so a re-run repeats them. ``generate`` keys its dropout by
(seed + 2, index), as gan_tpu folds ``PRNGKey(seed + 2)``; the bits are
torch's, not jax's, so the packages agree in distribution only.

**Epochs.** The eager step (``train_step``, ``eval_step`` and a subclass's
``_step``) draws inside the step and is the reference. ``fit`` runs each
epoch's full batches through a cached runner (:mod:`gan_tpu_torch.train.loop`,
one per (training, batch shape, caches)) whose step reads static buffers: the
batch's row indices and :class:`StepDraws`, drawn before each step from the
same keyed generators in the same call order as the eager step, so the
draws are bit-identical. On the card the runner replays a CUDA graph of
that step; the train and val graphs share one memory pool. ``load_state``
drops the runners, since loading replaces Adam's state tensors, whose
addresses a graph holds.

**Where the data lives.** ``fit`` plans each group of caches as gan_tpu's
``_storage_plan`` does (:func:`gan_tpu_torch.data.loader.plan_cache_storage`):
resident (copied whole to the device; the runner gathers each step's rows)
or streamed (a host array under ``--device-cache off`` or too large for the
device, or a FileCache, always). A streamed epoch (``_streamed_epoch``)
takes its host batches from a prefetch thread, in the resident epoch's order
and with its draws, and runs the full ones through a runner of its own whose
"cache" is :class:`~gan_tpu_torch.train.loop.StreamBuffers`, one batch on
the device that ``prepare`` fills before each step; the partial last batch
runs eagerly. So a streamed epoch equals the resident one bit for bit on the
CPU.

**Faults** (:mod:`gan_tpu_torch.train.recovery`): both trainers' ``fit`` run
each epoch's body through ``_fenced_epochs``, gan_tpu's fenced loop: an anchor
checkpoint first, and on a device fault a rewind to the latest checkpoint,
with the metric lists cut to match.

**Data parallelism** (gan_tpu_torch.parallel, gan_tpu's shard_map steps): a
trainer built with :class:`~gan_tpu_torch.parallel.Replicas` of W > 1 is one
replica of W, one process each, in one process group. Its parameters and
Adam's state start equal (the same seeded init, or ``--resume`` on every
rank) and stay equal: after each gradient group's ``autograd.grad`` its
flat gradients are averaged over the replicas by one bucketed
``all_reduce``, and so are the step's losses, before any update (no
``DistributedDataParallel``, whose reducer fires on ``.backward()``). Each
full global batch of B rows splits into ``local_batch`` = B / W rows per
replica, taken from the replica's stripe of a resident cache (rows r, r +
W, ...; :class:`Stripe`) or decoded by it from a streamed one, and a full
step's draws are keyed by the rank as well (gan_tpu folds the device index
into each step's key). The partial last batch runs whole on every replica
from the host cache, with rank-free draws (gan_tpu's device stream 0) and
per-replica batch norm, and its gradients are averaged too, so that the
replicas cannot drift bit by bit. At W = 1 a group changes no bit: the
average of one replica is a copy, and the draws carry no rank.

**Predict** walks an ndarray or a FileCache in chunks of 64 under a prefetch
thread that decodes the next chunk. The main thread launches a chunk's
inference and its copy to pinned host memory, then writes the previous
chunk's PNGs while the card computes, so no thread but the main one makes a
CUDA call and host memory stays bounded at any corpus size.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import time
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gan_tpu_torch.data import loader
from gan_tpu_torch.data.augment import normalize_batch
from gan_tpu_torch.device import torch_dtype
from gan_tpu_torch.models.blocks import keep_mask
from gan_tpu_torch.ops import kernels
from gan_tpu_torch.parallel import Replicas, stripe_rows
from gan_tpu_torch.train import loop
from gan_tpu_torch.train.optim import TF_ADAM_EPS, adam
from gan_tpu_torch.train.recovery import FaultFence
from gan_tpu_torch.utils.grids import save_image_grid
from gan_tpu_torch.utils.profiling import COUNTERS, profile_dir_from_env, span, trace


PREDICT_CHUNK = 64   # images predict decodes, infers and writes at a time, as gan_tpu does


def generator_depth(img_size: int) -> int:
    """The reference always builds 8 down blocks; cap by log2(img_size) so
    tiny test images still bottleneck at 1×1."""
    return min(8, int(math.log2(img_size)))


def raw_png_names(names, count: int) -> list[str]:
    """Unique .png names for the raw predictions: source stems, with a
    counter suffix when two sources differ only by extension."""
    if names is None:
        return [f"img{i}.png" for i in range(count)]
    out, seen = [], {}
    for n in names:
        stem = os.path.splitext(os.path.basename(n))[0]
        k = seen.get(stem, 0)
        seen[stem] = k + 1
        out.append((stem if k == 0 else f"{stem}__{k}") + ".png")
    return out


def write_raw(preds: np.ndarray, output_path: str, png_names) -> None:
    """Bare generated images (fp32 [-1, 1] -> uint8 PNGs) in prediction_images_raw/."""
    from PIL import Image

    raw_path = os.path.join(output_path, "prediction_images_raw")
    os.makedirs(raw_path, exist_ok=True)
    u8 = np.clip((preds + 1.0) * 127.5, 0, 255).astype(np.uint8)
    for i in range(u8.shape[0]):
        arr = u8[i, :, :, 0] if u8.shape[-1] == 1 else u8[i]
        Image.fromarray(arr).save(os.path.join(raw_path, png_names[i]))


class StepDraws(NamedTuple):
    """One step's random draws, in the eager step's call order: ``masks``,
    per generator pass, the keep-mask of each dropout site; ``jitter``, per
    jittered image batch, (row offsets, column offsets, flips); empty for a
    val step."""
    masks: list
    jitter: list

    def tensors(self) -> list[torch.Tensor]:
        return [m for app in self.masks for m in app] + [t for j in self.jitter for t in j]


class Stripe(NamedTuple):
    """A resident cache of a data-parallel replica: its stripe on the device
    (``local``: rows rank, rank + W, ... of ``host``) and the whole host
    cache, from which the partial last batch takes its rows."""
    local: torch.Tensor
    host: np.ndarray

    @property
    def shape(self) -> tuple:
        return self.host.shape


class GANTrainer:
    """``nets`` maps network names to modules; ``groups`` partitions the
    names into gradient groups, in the order the step takes their gradients;
    ``sampler`` names the generator that ``generate`` runs; ``replicas``
    (default: one, on the default device) says where the trainer runs and
    with which other replicas. ``ADAM_EPS`` is every network's Adam epsilon."""

    ADAM_EPS = TF_ADAM_EPS

    def __init__(self, config, nets: dict, groups: tuple, sampler: str, replicas: Replicas):
        self.config = config
        self.groups = groups
        self.replicas = replicas
        self.device = replicas.device
        self.local_batch = config.batch_size // replicas.size   # a full step's rows per replica
        # a full step's draws are keyed by the rank where W > 1; the partial
        # last batch takes the rank-free draws on every replica
        self._rank_key = (replicas.rank,) if replicas.size > 1 else ()
        self.dtype = torch_dtype(config.dtype)
        self.nets = {name: net.to(self.device) for name, net in nets.items()}
        self.params = {name: list(net.parameters()) for name, net in self.nets.items()}
        self.opts = {name: adam(p, config.learning_rate, config.beta_1, config.beta_2,
                                eps=self.ADAM_EPS, capturable=self.device.type == "cuda")
                     for name, p in self.params.items()}
        self.sampler = self.nets[sampler]
        self._sample_calls = 0   # fresh dropout draws per generate() call
        self._runners = {}       # (training, batch, caches) -> (runner, static buffers)
        self._graph_pool = None  # the runners' shared CUDA-graph memory pool
        self._streams = {}       # (training, batch shapes) -> loop.StreamBuffers
        # steps the runners ran eagerly, graph captures and replays; with a
        # group whose collectives cannot be captured, the steps on the card
        # that ran eagerly for that reason
        self.epoch_counts = {"eager": 0, "captures": 0, "replays": 0}
        if self.device.type == "cuda" and not replicas.capturable:
            self.epoch_counts["eager_by_backend"] = 0

    # ------------------------------------------------------------------ step
    def _draws(self, seed: int, *key: int) -> torch.Generator:
        state = np.random.SeedSequence([seed, *key]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(state))

    def _masks(self, net, generator: torch.Generator, batch: int) -> list[torch.Tensor]:
        """The keep-masks one forward of ``net`` at ``batch`` draws from
        ``generator``, in its dropout sites' order."""
        return [keep_mask(shape, generator, self.device)
                for shape in net.dropout_shapes(batch, self.config.img_size)]

    def _losses(self, x, y, generators, masks=None, bn_group=None):
        raise NotImplementedError

    def _step_draws(self, epoch: int, stream: int, step: int) -> StepDraws:
        """The draws of a full step of ``_step`` (epoch, stream, step)."""
        raise NotImplementedError

    def _epoch_step(self, caches: tuple, idx: tuple, draws: StepDraws,
                    training: bool) -> torch.Tensor:
        """``_step`` on static inputs: the rows ``idx[i]`` of ``caches[i]``
        and the draws ``draws``. Returns the (K,) losses."""
        raise NotImplementedError

    def gradients(self, x, y, generators=None, masks=None, bn_group=None):
        """({network: gradients of its total w.r.t. its parameters}, losses),
        with nothing updated: one ``autograd.grad`` per gradient group. x, y:
        normalized (N, S, S, C) batches. Dropout draws from ``generators``
        or takes ``masks`` (as ``StepDraws.masks``); with neither it is
        off. ``bn_group`` gives batch norm cross-replica statistics. With
        replicas in a group, each gradient group's gradients and the losses
        are their means over the replicas."""
        objectives, losses = self._losses(x, y, generators, masks, bn_group)
        grads = {}
        for i, (group, objective) in enumerate(zip(self.groups, objectives)):
            flat = torch.autograd.grad(objective, [p for n in group for p in self.params[n]],
                                       retain_graph=i < len(self.groups) - 1)
            flat = self.replicas.average(flat)
            for name in group:
                grads[name], flat = flat[:len(self.params[name])], flat[len(self.params[name]):]
        return grads, self.replicas.average([losses.detach()])[0]

    def apply_gradients(self, grads: dict) -> None:
        """One Adam update of each network from :meth:`gradients`' output: on
        the card one pass of csrc/adam.cu over every network's tensors, on
        the CPU each ``torch.optim.Adam``'s step (``kernels.adam_step``)."""
        kernels.adam_step(self.opts.values(), [grads[name] for name in self.opts])

    def train_step(self, x, y, generators=None, masks=None, bn_group=None) -> torch.Tensor:
        """One step of every network; returns the losses (on the device)."""
        grads, losses = self.gradients(x, y, generators, masks, bn_group)
        self.apply_gradients(grads)
        return losses

    @torch.no_grad()
    def eval_step(self, x, y, generators=None, masks=None, bn_group=None) -> torch.Tensor:
        return self.replicas.average([self._losses(x, y, generators, masks, bn_group)[1]])[0]

    # ----------------------------------------------------------------- epoch
    def _cached_epoch(self, caches: tuple, rows: tuple, epoch: int, training: bool,
                      fill: Optional[Callable[[], None]] = None) -> torch.Tensor:
        """The full steps of an epoch through the runner of (training, batch,
        caches): step s takes the rows ``rows[i][s]`` (a (steps, B) index
        tensor on the device) of ``caches[i]``; ``fill()``, when given,
        first loads the step's batch into the caches (a streamed epoch).
        Returns (steps, K) losses on the device."""
        n_steps, b = rows[0].shape
        stream = 0 if training else 1
        key = (training, b, tuple((c.data_ptr(), tuple(c.shape)) for c in caches))
        if key not in self._runners:
            idx = tuple(torch.empty(b, dtype=torch.int64, device=self.device) for _ in caches)
            draws = self._step_draws(epoch, stream, 0)   # the static draw buffers
            if self._graph_pool is None and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
            trainer = weakref.ref(self)   # no cycle: a dropped trainer frees its graphs at once
            runner = loop.make_cached_epoch(
                lambda: trainer()._epoch_step(caches, idx, draws, training), self.device,
                pool=self._graph_pool, counts=self.epoch_counts,
                capture=self.replicas.capturable)
            self._runners[key] = (runner, idx, draws)
        runner, idx, draws = self._runners[key]

        def prepare(s: int) -> None:
            with span("gan_tpu_torch.runner.prepare"):
                if fill is not None:
                    fill()
                for buf, r in zip(idx, rows):
                    buf.copy_(r[s])
                for buf, t in zip(draws.tensors(), self._step_draws(epoch, stream, s).tensors()):
                    buf.copy_(t)

        return runner(n_steps, prepare)

    def _streamed_epoch(self, caches: tuple, batches, full: int, tail: int, epoch: int,
                        training: bool) -> list[torch.Tensor]:
        """An epoch fed from the host: ``batches`` yields a tuple of uint8
        arrays (one per domain of ``caches``, host arrays or FileCaches) per
        step, ``full`` full batches and then, if ``tail``, the partial last
        one. A prefetch thread assembles them; the full steps run through
        the runner of this trainer's :class:`loop.StreamBuffers` of
        (training, batch shapes), the last one as the eager ``_step``.
        Returns the (steps, K) losses on the device, in pieces. The prefetch
        thread and a FileCache's threads have ended when it returns or
        raises."""
        b = self.local_batch
        losses = []

        def wait(it):
            t = time.perf_counter()
            with span("gan_tpu_torch.data.wait"):
                arrays = next(it)
            COUNTERS.add("data.wait_seconds", time.perf_counter() - t)
            COUNTERS.add("data.waits", 1)
            return arrays

        with contextlib.closing(loader.prefetch_iter(batches, depth=2)) as it:
            if full:
                shapes = tuple((b, *c.shape[1:]) for c in caches)
                if (training, shapes) not in self._streams:
                    self._streams[training, shapes] = loop.StreamBuffers(shapes, self.device)
                inp = self._streams[training, shapes]
                rows = tuple(torch.arange(b, device=self.device).expand(full, b) for _ in caches)
                losses.append(self._cached_epoch(inp.buffers, rows, epoch, training,
                                                 fill=lambda: inp.load(wait(it))))
            if tail:
                arrays = wait(it)
                with span("gan_tpu_torch.step.eager"):
                    u8 = [self._to_device(a) for a in arrays]
                    losses.append(self._step(*u8, epoch, 0 if training else 1, full)[None])
        return losses

    def _plan_caches(self, groups: list[tuple]) -> list[tuple]:
        """``fit``'s storage plan (gan_tpu's ``_storage_plan``): each group of
        caches, which share one decision, comes back on the device
        (resident) or as it is (streamed; always for a FileCache). Prints
        gan_tpu's line when anything streams. Over W > 1 replicas a
        resident cache is the replica's :class:`Stripe`, and the plan
        weighs a stripe's bytes."""
        w, r = self.replicas.size, self.replicas.rank
        plan = loader.plan_cache_storage(
            [None if any(isinstance(c, loader.FileCache) for c in g)
             else sum(-(-c.nbytes // w) for c in g) for g in groups],
            self.device, self.config.device_cache)
        if any(p != "resident" for p in plan):
            print(f"Device cache plan: train={plan[0]}, val={plan[1]} "
                  "(stream = batches fed from host).", flush=True)

        def resident(c):
            if w == 1:
                return torch.from_numpy(np.ascontiguousarray(c)).to(self.device)
            return Stripe(torch.from_numpy(c[stripe_rows(len(c), w, r)]).to(self.device), c)

        return [tuple(resident(c) for c in g) if p == "resident" else g
                for p, g in zip(plan, groups)]

    def _rank_batches(self, cache, full_rows: np.ndarray, tail_rows: np.ndarray):
        """A streamed epoch's host batches of one domain on this replica:
        ``local_batch`` rows at a time from ``full_rows`` (global row
        indices, step-major), then the partial last batch ``tail_rows``
        (empty: none). A FileCache decodes only these rows."""
        b = self.local_batch
        if len(tail_rows) <= b:   # the tail is the last chunk of one pass
            return loader.iter_uint8_batches(cache, b, np.concatenate([full_rows, tail_rows]))
        return itertools.chain(loader.iter_uint8_batches(cache, b, full_rows),
                               loader.iter_uint8_batches(cache, len(tail_rows), tail_rows))

    def _tail_rows(self, cache, rows: np.ndarray) -> torch.Tensor:
        """The partial last batch's uint8 rows (global indices) on the
        device: gathered from a resident cache where it is whole (one
        replica), else copied from the host cache of its :class:`Stripe`."""
        if isinstance(cache, Stripe):
            return self._to_device(cache.host[rows])
        return cache[torch.from_numpy(rows).to(self.device)]

    def _timed_epoch(self, run: Callable[[], np.ndarray], epoch: int, start_epoch: int,
                     images: Callable[[np.ndarray], int], unit: str):
        """``run()`` (the train epoch), traced into ``GAN_TPU_PROFILE_DIR`` at
        epoch start_epoch + 1 and timed to the card's synchronisation; under
        ``GAN_TPU_PERF=1`` it prints the epoch's rate, as gan_tpu does, and
        then the epoch's own share of ``COUNTERS`` and ``epoch_counts``: the
        main thread's waits on streamed batches and their seconds, the
        decoder's files per second of its busy time, the steps run eagerly,
        the captures and replays, and the captures' seconds."""
        counters, steps = COUNTERS.snapshot(), dict(self.epoch_counts)
        t0 = time.perf_counter()
        with trace(profile_dir_from_env() if epoch == start_epoch + 1 else None):
            out = run()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if os.environ.get("GAN_TPU_PERF") == "1":
            rate = images(out) / dt if dt > 0 else float("inf")
            now = COUNTERS.snapshot()
            d = lambda k: now.get(k, 0) - counters.get(k, 0)
            files_per_s = d("decode.files") / d("decode.seconds") if d("decode.seconds") else 0.0
            runs = ", ".join(f"{k} {self.epoch_counts[k] - steps[k]}"
                             for k in ("eager", "captures", "replays"))
            print(f"[perf] epoch {epoch + 1}: {rate:.1f} {unit}/sec "
                  f"({rate / self.replicas.size:.1f}/chip); data wait "
                  f"{d('data.wait_seconds'):.3f} s in {d('data.waits')} waits, decode "
                  f"{files_per_s:.1f} files/s, {runs}, capture "
                  f"{d('runner.capture_seconds'):.2f} s", flush=True)
        return out

    def _fenced_epochs(self, body: Callable[[int], None], manager, start_epoch: int,
                       costs: tuple) -> None:
        """``body(epoch)`` for each epoch from ``start_epoch`` to the last,
        inside a :class:`~gan_tpu_torch.train.recovery.FaultFence` (gan_tpu's
        ``fit`` loop): first an anchor checkpoint at ``start_epoch`` where
        ``manager`` holds none; on a fault the fence rewinds to the latest
        checkpoint and each metric list of ``costs`` (dicts of per-epoch
        lists) is cut to the epochs before it, or it raises TrainingFault."""
        fence = FaultFence(self, manager)
        if manager is not None and manager.latest_epoch() is None:
            manager.save(start_epoch, self.state(), anchor=True)
        epoch = start_epoch
        while epoch < self.config.epochs:
            try:
                body(epoch)
            except Exception as e:
                epoch = fence.recover(epoch, e)
                for cost in costs:
                    for values in cost.values():
                        del values[epoch - start_epoch:]
                continue
            epoch += 1

    def _checkpoint_every(self, done: int, manager) -> None:
        """``--checkpoint-every N``: a save after every N epochs besides the
        reference's cadence, unless this epoch was just saved
        (gan_tpu/train/pix2pix_trainer.py:591-594)."""
        every = self.config.checkpoint_every
        if every and manager is not None and done % every == 0 and manager.latest_epoch() != done:
            manager.save(done, self.state())

    # --------------------------------------------------------------- predict
    @torch.no_grad()
    def _forward(self, x: torch.Tensor, index: int, per_sample: bool) -> torch.Tensor:
        return self.sampler(x, generator=self._draws(self.config.seed + 2, index),
                            compute_dtype=self.dtype, per_sample=per_sample)

    def generate(self, input_batch: np.ndarray, key_index: Optional[int] = None) -> np.ndarray:
        """The sampler's G(x) with training-mode semantics (dropout on, batch
        statistics). ``key_index`` selects the dropout draws; when omitted a
        per-call counter supplies it."""
        if key_index is None:
            key_index = self._sample_calls
            self._sample_calls += 1
        x = torch.from_numpy(np.ascontiguousarray(input_batch)).to(self.device, self.dtype)
        return self._forward(x, key_index, per_sample=False).cpu().numpy()

    def generate_batched(self, inputs: np.ndarray, chunk: int = 16) -> np.ndarray:
        """Chunked batched inference, exact against one forward per image:
        every norm takes each image's own statistics (batch norm through
        ``per_sample``; instance norm is per sample anyway). uint8 inputs are
        normalized to [-1, 1] on the device. Chunk dropout draws are keyed by
        the chunk offset."""
        return self._generate_on_device(inputs, chunk).cpu().numpy()

    def _generate_on_device(self, inputs: np.ndarray, chunk: int) -> torch.Tensor:
        """``generate_batched``'s fp32 outputs, left on the device."""
        x = self._to_device(inputs)
        outs = []
        for lo in range(0, x.shape[0], chunk):
            xs = x[lo:lo + chunk]
            xs = normalize_batch(xs, self.dtype) if xs.dtype == torch.uint8 else xs.to(self.dtype)
            outs.append(self._forward(xs, lo, per_sample=True))
        return torch.cat(outs)

    def _predict(self, cache, output_path: str, raw: bool, raw_names,
                 inputs: Callable[[np.ndarray], np.ndarray], panels: Callable) -> None:
        """prediction_images/img{N}.png for each row of ``cache`` (an ndarray
        or a FileCache), in chunks of ``PREDICT_CHUNK``: ``inputs(batch)`` is
        what the sampler takes, ``panels(row, pred)`` the grid's images from
        the normalized row and its prediction. With ``raw``, the bare
        predictions too. Chunk k + 1 is decoded on a prefetch thread and
        its inference runs on the card while chunk k's PNGs are written."""
        plot_path = os.path.join(output_path, "prediction_images")
        os.makedirs(plot_path, exist_ok=True)
        png_names = raw_png_names(raw_names, cache.shape[0]) if raw else None

        def write(off, batch, preds, copied):
            if copied is not None:
                copied.synchronize()
            preds = preds.numpy()
            for i in range(batch.shape[0]):
                save_image_grid(panels(batch[i].astype(np.float32) / 127.5 - 1.0, preds[i]),
                                os.path.join(plot_path, f"img{off + i}.png"),
                                channels=self.config.channels)
            if raw:
                write_raw(preds, output_path, png_names[off:off + batch.shape[0]])

        pending, off = None, 0
        chunks = loader.iter_uint8_batches(cache, PREDICT_CHUNK)
        with contextlib.closing(loader.prefetch_iter(chunks, depth=1)) as batches:
            for batch in batches:
                current = (off, batch, *self._to_host(self._generate_on_device(inputs(batch), 16)))
                if pending is not None:
                    write(*pending)
                pending, off = current, off + batch.shape[0]
        if pending is not None:
            write(*pending)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device. On the card it goes through pinned
        memory, so the host does not wait for the work queued before the
        copy (a copy from pageable memory would)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """``t`` copied to the host without waiting: on the card a pinned
        copy and the event that marks it done, on the CPU ``t`` itself."""
        if self.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    # ------------------------------------------------------------ state mgmt
    def state(self) -> dict:
        """{"params": {network: state_dict}, "opt_states": {network: Adam
        state_dict}}: tensors and plain values only, for ``weights_only``."""
        return {"params": {name: net.state_dict() for name, net in self.nets.items()},
                "opt_states": {name: opt.state_dict() for name, opt in self.opts.items()}}

    def load_state(self, state: dict) -> None:
        """Load a state from :meth:`state`, or a generators-only one (what a
        predict checkpoint needs). Drops the cached epoch runners: Adam's
        ``load_state_dict`` replaces the state tensors that a captured graph
        reads, so the next epoch captures anew. The streamed epochs' buffers
        stay: the new runners capture against them. Adam's moments take
        their parameters' layout (``kernels.adam_relayout``), whatever
        layout they were saved in."""
        self._runners.clear()
        self._graph_pool = None
        params = state["params"]
        for name, net in self.nets.items():
            if name in params or name.startswith("gen"):
                net.load_state_dict(params[name])
        for name, opt_state in state.get("opt_states", {}).items():
            self.opts[name].load_state_dict(opt_state)
            kernels.adam_relayout(self.opts[name])
