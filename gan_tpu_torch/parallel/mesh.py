"""Replicas of a trainer on torch.distributed (counterpart of gan_tpu/parallel/mesh.py).

gan_tpu runs one controller over a 1-D ``('data',)`` mesh: parameters and
Adam's state replicated, each batch split over the devices, the gradients
``pmean``-ed. Here each replica is one process that owns one device,
PyTorch's idiom, and the W processes form one process group:
:class:`Replicas` is what a trainer takes in place of the mesh.

* Joining (``make_mesh`` / ``init_multihost``): :func:`launch` builds the
  group from torchrun's environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``) where it is set; otherwise, for
  ``--num-devices N`` > 1, it spawns the N ranks itself
  (``torch.multiprocessing``, spawn) around a ``FileStore`` under the output
  directory, so that no TCP port can collide. The backend is NCCL on CUDA
  and gloo on the CPU. A group that fails to form raises, as
  ``init_multihost`` does for explicit settings: nothing degrades to N
  independent runs.
* The world size (gan_tpu's ``_auto_devices``, which shrinks the mesh until
  it divides the batch): :func:`world_size`. The port cannot shrink a fixed
  world, so a batch that the asked world does not divide, or a world that
  the devices or ``WORLD_SIZE`` cannot give, exits with an error; with
  ``--num-devices 0`` it takes the largest world up to the devices present
  that divides the batch, and says so when that is fewer than are present.
* Collectives: :meth:`Replicas.average` (gradients and losses: one
  ``all_reduce`` of a flat bucket, summed then divided, since gloo has no
  ``ReduceOp.AVG``) and :func:`replica_mean` (cross-replica batch norm's
  moments, with autograd through the collective: its backward all-reduces
  the gradient, as the transpose of gan_tpu's ``psum`` does).
* :func:`stripe_rows` (``process_stripe_rows``): the rows of a corpus a rank
  holds, ``rank, rank + W, ...`` (gan_tpu's ``put_cache`` striping).

The port keeps its own copy of all of this and imports nothing of gan_tpu.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings
from datetime import timedelta
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gan_tpu_torch.device import default_device
from gan_tpu_torch.train import recovery

DEFAULT_TIMEOUT = timedelta(minutes=30)   # torch's own default for a gloo group


@dataclasses.dataclass(frozen=True)
class Replicas:
    """Where a trainer runs: replica ``rank`` of ``size`` on ``device``, in
    ``group`` (None: one process, no collective) over ``backend``.
    ``local_size`` is the number of ranks on this host, which share its
    cores."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None
    local_size: int = 1

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may capture this group's collectives: NCCL's
        can be captured, gloo's run on the host and cannot."""
        return self.backend != "gloo"

    def average(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor replaced in place by its mean over the replicas, through
        one ``all_reduce`` of their flat concatenation (one bucket): summed,
        then divided by the size. The tensors keep their memory layouts, so
        what reads them (Adam) runs as it does without replicas; at one
        replica they keep every bit. Returns the tensors."""
        if self.group is None:
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view(t.shape))
        return list(tensors)

    def broadcast(self, obj):
        """Rank 0's ``obj`` (picklable) on every replica; ``obj`` itself
        without a group."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def single(device: Optional[torch.device] = None) -> Replicas:
    """One replica and no group: the port without data parallelism."""
    return Replicas(device=default_device() if device is None else device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, whose backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def replica_mean(tensor: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The mean of ``tensor`` over the replicas of ``group``, differentiable:
    the gradient of each replica's input is the mean of every replica's
    gradient of the output (gan_tpu's ``pmean`` under ``jax.grad``)."""
    return _AllReduceSum.apply(tensor, group) / dist.get_world_size(group)


def stripe_rows(n: int, size: int, rank: int) -> np.ndarray:
    """The rows of an ``n``-row corpus that replica ``rank`` of ``size``
    holds and decodes: row i belongs to rank i % size, at local index
    i // size (gan_tpu's ``process_stripe_rows`` with one device per
    process, without its padding rows: a rank's stripe may be one row
    shorter, and no epoch draws past the shortest)."""
    return np.arange(rank, n, size)


def join(rank: int, size: int, device: torch.device, *, store=None, init_method=None,
         backend: Optional[str] = None, local_size: Optional[int] = None,
         timeout: timedelta = DEFAULT_TIMEOUT) -> Replicas:
    """Join the default process group as ``rank`` of ``size`` and return the
    replica on ``device``. ``store`` (a ``dist.Store``) or ``init_method``
    (``env://`` under torchrun) says how the ranks meet; ``backend`` defaults
    to NCCL on CUDA and gloo on the CPU. A failure raises."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, init_method=init_method, rank=rank,
                            world_size=size, timeout=timeout)
    return Replicas(rank=rank, size=size, device=device, group=dist.group.WORLD,
                    backend=backend, local_size=size if local_size is None else local_size)


def leave(replicas: Replicas) -> None:
    """Destroy the replicas' process group, if they have one."""
    if replicas.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def devices_present(device: torch.device) -> int:
    """The devices one rank each may take: the cards, or on the CPU its cores."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


def _largest_divisor(batch: int, limit: int) -> int:
    return max(w for w in range(1, max(1, min(batch, limit)) + 1) if batch % w == 0)


def world_size(num_devices: int, batch_size: int, present: int,
               fixed: Optional[int] = None) -> int:
    """The number of replicas of a training run: ``--num-devices`` (0: the
    devices present, or ``fixed``, the world size torchrun set). Exits with
    an error where the devices or ``fixed`` cannot give the world asked for,
    and where the world does not divide the global batch, naming the
    largest world that does: the port never runs on fewer devices than
    asked. With 0 and no ``fixed`` world, it takes the largest world up to
    ``present`` that divides the batch, with a warning when that is fewer
    (gan_tpu's ``_auto_devices`` shrinks the mesh silently)."""
    if fixed is not None and num_devices and num_devices != fixed:
        raise SystemExit(f"--num-devices {num_devices} differs from the world of {fixed} "
                         "ranks that torchrun started (WORLD_SIZE)")
    if num_devices > present:
        raise SystemExit(f"--num-devices {num_devices} asks for more devices than the "
                         f"{present} present")
    size = num_devices or fixed
    if size is None:
        size = _largest_divisor(batch_size, present)
        if size < present:
            warnings.warn(f"--num-devices 0: {size} of the {present} devices present train, "
                          f"the most that divide the global batch of {batch_size}")
        return size
    if batch_size % size:
        raise SystemExit(f"the global batch of {batch_size} does not divide over {size} "
                         f"replicas; the largest number of replicas that divides it is "
                         f"{_largest_divisor(batch_size, size)}")
    return size


def _run(fn: Callable, cfg, replicas: Replicas):
    try:
        return fn(cfg, replicas)
    finally:
        leave(replicas)


def _spawned(index: int, fn: Callable, cfg, size: int, store_path: str,
             timeout: timedelta) -> None:
    """Rank ``index`` of a world that :func:`launch` spawned."""
    device = default_device()
    if device.type == "cuda":
        device = torch.device("cuda", index)
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // size))
    store = dist.FileStore(store_path, size)
    _run(fn, cfg, join(index, size, device, store=store, timeout=timeout))


def launch(fn: Callable, cfg, *, timeout: timedelta = DEFAULT_TIMEOUT):
    """Run ``fn(cfg, replicas)`` once per replica of a ``--train`` run, or
    once on one device for ``--predict`` (gan_tpu predicts on one device).

    Under torchrun every process is a rank already. Otherwise a world of
    one runs in this process, and a larger one in as many spawned
    processes, which meet through a ``FileStore`` in ``cfg.output``
    (removed when they end); a rank that fails ends the others and raises
    here, and a rank that exits 17 (a fault the fence could not rewind, its
    resume line printed; train/recovery.py) ends the others and exits 17
    here too."""
    device = default_device()
    if not cfg.train:
        return fn(cfg, Replicas(device=device))
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        size = world_size(cfg.num_devices, cfg.batch_size, int(env["WORLD_SIZE"]),
                          fixed=int(env["WORLD_SIZE"]))
        if device.type == "cuda":
            device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        return _run(fn, cfg, join(int(env["RANK"]), size, device, init_method="env://",
                                  local_size=int(env.get("LOCAL_WORLD_SIZE", size)),
                                  timeout=timeout))
    # on the CPU, --num-devices 0 trains in this process: spawning a rank per
    # core is asked for by number only
    present = devices_present(device) if device.type == "cuda" or cfg.num_devices else 1
    size = world_size(cfg.num_devices, cfg.batch_size, present)
    if size == 1:
        return fn(cfg, Replicas(device=device))
    os.makedirs(cfg.output, exist_ok=True)
    store_path = os.path.join(cfg.output, f".replicas-{os.getpid()}-{time.time_ns()}")
    sys.stdout.flush()
    try:
        torch.multiprocessing.start_processes(_spawned, args=(fn, cfg, size, store_path, timeout),
                                              nprocs=size, start_method="spawn")
    except torch.multiprocessing.ProcessExitedException as err:
        if err.exit_code == recovery.EXIT_CODE:
            raise SystemExit(recovery.EXIT_CODE) from None
        raise
    finally:
        if os.path.exists(store_path):
            os.remove(store_path)
