"""Tracing hooks (counterpart of gan_tpu/utils/profiling.py).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that writes
  a Chrome trace of the host and the card into ``logdir`` (``fit`` traces
  its second epoch when ``GAN_TPU_PROFILE_DIR`` is set).
* ``span(name)``: a ``torch.profiler.record_function`` range named one of
  ``SPANS``, opened only while the profiler records on the calling thread;
  otherwise a shared no-op. The profiler records the ranges of the thread
  that started it, so spans open and close on the main thread, and never
  inside a CUDA-graph capture (a capture records its ranges once, and a
  replay none).
* ``COUNTERS``: a process-wide tally of the work done on threads that spans
  cannot see, and of the main thread's waits on them: ``decode.files`` and
  ``decode.seconds`` (a FileCache's producers: files decoded, seconds in its
  ``rows`` calls), ``data.waits`` and ``data.wait_seconds`` (a streamed
  epoch's ``next()`` on its prefetch queue), ``runner.capture_seconds``
  (the epoch runners' CUDA-graph captures).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

# every span the program opens, one a line; benchmark readers import this
SPANS = (
    "gan_tpu_torch.epoch",           # one train or val pass, run_epoch end to end
    "gan_tpu_torch.epoch.plan",      # the pass's row plan and the rows' copy to the card
    "gan_tpu_torch.epoch.fetch",     # the pass's losses to the host: its one synchronisation
    "gan_tpu_torch.runner.prepare",  # a runner step's inputs: the streamed fill, indices, draws
    "gan_tpu_torch.runner.replay",   # a CUDA-graph replay
    "gan_tpu_torch.runner.capture",  # a CUDA-graph capture, from outside it
    "gan_tpu_torch.step.eager",      # one step run op by op: warm-up, CPU, gloo, tails
    "gan_tpu_torch.data.wait",       # the main thread's next() on a streamed epoch's queue
    "gan_tpu_torch.data.h2d",        # StreamBuffers.load: slot wait, pinned copy, async copy
)

_NO_SPAN = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """``torch.profiler.record_function(name)`` while the profiler records
    on this thread, else the shared no-op (well under a microsecond)."""
    if not _recording():
        return _NO_SPAN
    if name not in SPANS:
        raise ValueError(f"{name!r} is not one of profiling.SPANS")
    return torch.profiler.record_function(name)


class Counters:
    """Named running sums, safe to add to from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sums: dict = {}

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self._sums[name] = self._sums.get(name, 0) + value

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._sums)


COUNTERS = Counters()


@contextlib.contextmanager
def trace(logdir: str | None):
    """Host and device profiler trace into ``logdir`` when it is set; no-op
    otherwise. The file is ``trace_<pid>_<ns>.json`` (Chrome trace format,
    for chrome://tracing or Perfetto)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def profile_dir_from_env() -> str | None:
    return os.environ.get("GAN_TPU_PROFILE_DIR") or None
