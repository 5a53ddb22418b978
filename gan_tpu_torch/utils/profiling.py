"""Tracing and throughput hooks (counterpart of gan_tpu/utils/profiling.py).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that writes
  a Chrome trace of the host and the card into ``logdir`` (``fit`` traces
  its second epoch when ``GAN_TPU_PROFILE_DIR`` is set).
* ``Throughput``: epoch-level images/s and images/s/chip, which ``fit``
  prints under ``GAN_TPU_PERF=1``.

``torch.profiler`` is imported inside ``trace``, so importing this module
stays cheap.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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


class Throughput:
    """Accumulates (images, seconds) and reports images/sec/chip."""

    def __init__(self, n_devices: int):
        self.n_devices = max(1, n_devices)
        self.images = 0
        self.seconds = 0.0
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, images: int) -> float:
        """Returns this interval's images/sec."""
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.images += images
        self.seconds += dt
        return images / dt if dt > 0 else float("inf")

    @property
    def images_per_sec(self) -> float:
        return self.images / self.seconds if self.seconds else 0.0

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / self.n_devices

    def summary(self) -> str:
        return (f"{self.images_per_sec:.1f} images/sec "
                f"({self.images_per_sec_per_chip:.1f}/chip over "
                f"{self.n_devices} devices)")
