"""Fault recovery for training runs (counterpart of gan_tpu/train/recovery.py).

Both trainers' ``fit`` run every epoch through a :class:`FaultFence`
(:meth:`gan_tpu_torch.train.base.GANTrainer._fenced_epochs`):

* A device fault (``RuntimeError``, ``OSError``, ``ConnectionError``; on
  torch also ``torch.AcceleratorError``, ``torch.OutOfMemoryError`` and
  ``torch.distributed.DistBackendError``, all of them ``RuntimeError``)
  triggers an in-process REWIND: the last checkpoint of this run is
  restored and the epochs from there run again. The epochs are pure in
  (state, seed, epoch, step), so the re-run reproduces the epochs the fault
  destroyed; ``fit`` cuts its metric lists to match. Logic errors
  (``ValueError``, ``TypeError``, ``AssertionError``, ...), the five
  filesystem ``OSError`` kinds and ``KeyboardInterrupt`` propagate unchanged.
* ``fit`` saves an epoch-``start_epoch`` anchor checkpoint before its first
  epoch, so that a rewind target always exists; the next save deletes it
  (``CheckpointManager.save(anchor=True)``). ``--checkpoint-every N`` bounds
  the epochs a fault costs.
* Before a restore the fence makes the recapture start clean: it drops the
  fault's traceback, which would pin the failed step's activations, and
  collects garbage; ``load_state`` drops the epoch runners and their graph
  pool. A streamed epoch's producer threads have ended when its epoch
  raises (``GANTrainer._streamed_epoch``), and a capture that fails leaves
  no stream capturing (``loop.CachedEpoch``).
* When the retries are spent or the restore fails, the fence takes an
  EMERGENCY snapshot of the state it can still fetch, under the failing
  epoch's index unless the latest checkpoint already holds that epoch, and
  raises :class:`TrainingFault`; the CLIs print a resume-ready ``--resume``
  line and exit 17 (:func:`exit_for_resume`). The port updates parameters
  in place on every path, so a snapshot taken after a fault inside an epoch
  holds a batch-boundary state, not an epoch-boundary one: resuming from it
  is sound training but not bit-equal to an uninterrupted run (gan_tpu
  says so of its host-streaming path only). Periodic checkpoints stay
  epoch-exact.
* ``GAN_TPU_FAULT_RETRIES`` bounds the rewinds of one ``fit`` (default 3;
  0 disables the fence: every exception propagates as it was raised).

Where the port differs from gan_tpu:

* **Sticky faults.** After an illegal address, a ``__trap()`` or an Xid
  every CUDA call of the process fails. Before it restores anything the
  fence synchronises the trainer's device; where that raises, it goes
  straight to the emergency exit without a rewind, fetches nothing and
  names the last periodic checkpoint (gan_tpu's "device state unfetchable"
  branch). The fault it raises has ``device_lost`` set, and the CLI leaves
  with ``os._exit(17)``: at interpreter exit the caching allocator and the
  graphs' destructors would call into the dead context.
* **Worlds above one.** gan_tpu has one controller; the port has one
  process per rank, and a rank cannot rewind alone while its peers wait in
  a collective. So at a world above one the fence makes no rewind: the
  faulting rank goes to the emergency exit, where only a rank that holds a
  checkpoint manager writes, and exits 17; ``parallel.launch`` (or
  torchrun's agent) ends the other ranks and reports 17.
"""

from __future__ import annotations

import gc
import os
import sys
from typing import NoReturn, Optional

import torch

EXIT_CODE = 17   # what a CLI returns after a TrainingFault: resume the run


class TrainingFault(RuntimeError):
    """Unrecoverable device fault; carries the resume point (if any).
    ``device_lost``: the fault poisoned the process's CUDA context."""

    def __init__(self, epoch: int, checkpoint_epoch: Optional[int],
                 checkpoint_dir: Optional[str], cause: BaseException, *,
                 device_lost: bool = False):
        self.epoch = epoch
        self.checkpoint_epoch = checkpoint_epoch
        self.checkpoint_dir = checkpoint_dir
        self.cause = cause
        self.device_lost = device_lost
        where = (f"state for epoch {checkpoint_epoch} saved in {checkpoint_dir}"
                 if checkpoint_epoch is not None else "no checkpoint available")
        super().__init__(
            f"device fault during epoch {epoch + 1} "
            f"({type(cause).__name__}: {cause}); {where}")


def is_device_fault(exc: BaseException) -> bool:
    """Faults worth recovering from: runtime and transport failures, which
    on torch include CUDA errors, out-of-memory and collective failures (all
    ``RuntimeError``). Logic errors (ValueError, TypeError,
    AssertionError, ...) and KeyboardInterrupt are not, nor are the
    filesystem OSErrors of the epoch body's PNG and checkpoint writes:
    retrying a missing or forbidden path would mask the real problem."""
    if isinstance(exc, (FileNotFoundError, PermissionError, NotADirectoryError,
                        IsADirectoryError, FileExistsError)):
        return False
    return isinstance(exc, (RuntimeError, OSError, ConnectionError))


def max_recoveries() -> int:
    return int(os.environ.get("GAN_TPU_FAULT_RETRIES", "3"))


def device_alive(device: torch.device) -> bool:
    """False where the device's context is poisoned: a synchronisation of a
    CUDA device raises. The CPU is always alive."""
    if device.type != "cuda":
        return True
    try:
        torch.cuda.synchronize(device)
    except RuntimeError:
        return False
    return True


def _drop_frames(exc: BaseException) -> None:
    """Clear the tracebacks of ``exc`` and of the exceptions it chains, so
    that their frames (the failed step's activations, a streamed epoch's
    generators) are freed before the re-run."""
    todo, seen = [exc], set()
    while todo:
        e = todo.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        e.__traceback__ = None
        todo += [e.__cause__, e.__context__]
    gc.collect()


class FaultFence:
    """The recovery of one ``fit``. Usage::

        fence = FaultFence(trainer, manager)
        epoch = start_epoch
        while epoch < cfg.epochs:
            try:
                <epoch body>
            except Exception as e:
                epoch = fence.recover(epoch, e)   # rewound epoch, or raises
                <truncate metric lists to epoch - start_epoch entries>
                continue
            epoch += 1
    """

    def __init__(self, trainer, manager):
        self.trainer = trainer
        self.manager = manager
        self.used = 0
        self.limit = max_recoveries()

    def recover(self, epoch: int, exc: BaseException) -> int:
        if self.limit <= 0 or not is_device_fault(exc):
            raise exc
        self.used += 1
        print(f"\n[recovery] device fault during epoch {epoch + 1} "
              f"({type(exc).__name__}: {exc}) — attempt "
              f"{self.used}/{self.limit}", flush=True)
        if not device_alive(self.trainer.device):
            print("[recovery] the device's context is lost: no rewind in this process",
                  flush=True)
            self._emergency(epoch, exc, fetch=False)
        if self.used > self.limit:
            self._emergency(epoch, exc)
        world = self.trainer.replicas.size
        if world > 1:
            print(f"[recovery] no rewind at a world of {world} replicas", flush=True)
            self._emergency(epoch, exc)
        latest = self.manager.latest_epoch() if self.manager is not None else None
        if latest is None:
            self._emergency(epoch, exc)
        _drop_frames(exc)
        try:
            self.trainer.load_state(self.manager.restore(map_location="cpu"))
        except Exception:
            self._emergency(epoch, exc)
        print(f"[recovery] rewound to checkpoint at epoch {latest}; "
              "re-running from there", flush=True)
        return latest

    def _emergency(self, epoch: int, exc: BaseException, *, fetch: bool = True) -> NoReturn:
        """Last resort: snapshot the state that is still fetchable (nothing
        where ``fetch`` is False: the context is lost), then raise
        TrainingFault."""
        saved_epoch, saved_dir = None, None
        if self.manager is not None:
            saved_epoch, saved_dir = self.manager.latest_epoch(), self.manager.directory
            if fetch:
                try:
                    if self.manager.latest_epoch() != epoch:
                        self.manager.save(epoch, self.trainer.state())
                    saved_epoch = epoch
                    print(f"[recovery] emergency checkpoint saved at epoch "
                          f"{epoch} in {saved_dir}", flush=True)
                except Exception:
                    fetch = False
            if not fetch:
                print("[recovery] device state unfetchable; last periodic "
                      f"checkpoint is epoch {saved_epoch}", flush=True)
        raise TrainingFault(epoch, saved_epoch, saved_dir, exc,
                            device_lost=not device_alive(self.trainer.device)) from exc


def exit_for_resume(fault: TrainingFault, run_dir: str, lead: bool = True) -> NoReturn:
    """The CLIs' end of a run that the fence could not save in-process:
    print the fault and ``Resume with the original flags plus: --resume
    <run_dir>`` (on stdout, or on stderr for a rank other than the lead,
    whose stdout is silenced), then exit 17. After a fault that lost the
    device's context it leaves with ``os._exit``, past the destructors that
    would call into the dead context."""
    out = sys.stdout if lead else sys.stderr
    print(f"\n{fault}", file=out, flush=True)
    print(f"Resume with the original flags plus: --resume {run_dir}", file=out, flush=True)
    if fault.device_lost:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_CODE)
    raise SystemExit(EXIT_CODE)
