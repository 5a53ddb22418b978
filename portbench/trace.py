"""The traced stretch: one whole epoch (train, then val) of the window under
``torch.profiler``, its Chrome trace written to ``portbench/cache/traces``,
and its reduction to what the per-layer metrics and the result's
``breakdown`` read: device operations, the device's busy seconds inside the
stretch, and its idle gaps labelled by what the host was doing.

A per-layer metric is a module ``portbench/metrics/<name>.py`` whose
``read(stretch)`` returns its value, or None where the stretch holds
nothing for it to read (``load_reader``). A kernel's roofline share
(``roofline_pct``) names its kernels by substrings of their names and takes
its operations' bound from ``portbench.counts``.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import os
import time
from dataclasses import dataclass, field

from portbench import counts

ROOT = os.path.dirname(os.path.abspath(__file__))
TRACES = os.path.join(ROOT, "cache", "traces")
SPAN = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SHORT_GAP_US = 20.0   # idle gaps below this are summed under one label
# kernel groups by substring of the kernel name, first match wins (chip_smoke.py's grouping)
GROUPS = (("S", ("stem_conv_kernel", "stem_conv_mma_kernel")),
          ("K1", ("instance_norm_fwd_kernel",)),
          ("K2", ("instance_norm_bwd_kernel",)),
          ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
          ("Adam", ("multi_tensor_apply",)),
          ("casts and copies", ("copy_kernel",)),
          ("cat", ("CatArrayBatchedCopy",)),
          ("convs", ("xmma", "cutlass", "cudnn", "conv", "Nhwc", "Nchw", "wgrad", "dgrad")))


def group(name: str) -> str:
    return next((g for g, keys in GROUPS if any(k in name for k in keys)), "other")


@dataclass
class Stretch:
    """What a reader reads. ``device``: (name, start µs, duration µs) of every
    device operation inside the stretch; ``start``, ``end``: the stretch's
    span (µs); ``config``; ``steps``: (training, count, bx, by) of its steps;
    ``window``: {"seconds", "train_flops"} of the window's untraced epochs."""
    device: list
    start: float
    end: float
    config: dict
    steps: list
    window: dict
    host: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_us(self) -> float:
        busy, reach = 0.0, self.start
        for _name, ts, dur in sorted(self.device, key=lambda e: e[1]):
            lo, hi = max(ts, reach), min(ts + dur, self.end)
            if hi > lo:
                busy += hi - lo
                reach = hi
        return busy

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, reach = [], self.start
        for _name, ts, dur in sorted(self.device, key=lambda e: e[1]):
            if ts > reach:
                gaps.append((reach, min(ts, self.end)))
            reach = max(reach, ts + dur)
        if reach < self.end:
            gaps.append((reach, self.end))
        return [(a, b) for a, b in gaps if b > a]


@contextlib.contextmanager
def profiled(name: str, holder: dict):
    """Profiles the block on the CPU and the card; ``holder["events"]`` is then
    (activity type, name, start µs, duration µs) of every event, and
    ``holder["trace"]`` the path of its Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            yield
    t = time.perf_counter()
    holder["events"] = [(_kind(e), e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
                        for e in prof.profiler.kineto_results.events()]
    holder["read_s"] = time.perf_counter() - t
    os.makedirs(TRACES, exist_ok=True)
    holder["trace"] = os.path.join(TRACES, f"{name}.json")
    t = time.perf_counter()
    prof.export_chrome_trace(holder["trace"])
    holder["write_s"] = time.perf_counter() - t


def _kind(event) -> str:
    """The event's Chrome-trace category; where torch's event does not name it,
    "kernel" for any device event that is no annotation's range, else
    "cpu_op" or "user_annotation"."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    from torch.autograd import DeviceType
    note = event.is_user_annotation() if hasattr(event, "is_user_annotation") else False
    if event.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if note or event.name() == SPAN \
            or event.name().startswith("Optimizer.") else "kernel"
    return "user_annotation" if note or event.name() == SPAN else "cpu_op"


def load(events: list, config: dict, steps: list, window: dict) -> Stretch:
    """The stretch of ``profiled``'s events inside its span."""
    span = [e for e in events if e[1] == SPAN and e[0] == "user_annotation"]
    if not span:
        raise RuntimeError(f"the profile holds no {SPAN} span")
    start, end = span[0][2], span[0][2] + span[0][3]
    device = [(name, ts, dur) for kind, name, ts, dur in events
              if kind in DEVICE_CATS and start <= ts < end]
    host = sorted((ts, ts + dur, name) for kind, name, ts, dur in events
                  if kind in HOST_CATS and name != SPAN)
    return Stretch(device, start, end, config, steps, window, host)


def breakdown(stretch: Stretch, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing at each gap's start (the innermost host event then);
    gaps under SHORT_GAP_US are summed under one label. Seconds."""
    ops: dict = {}
    for name, _ts, dur in stretch.device:
        ops[name] = ops.get(name, 0.0) + dur / 1e6
    starts = [h[0] for h in stretch.host]
    idle: dict = {}
    short = f"gaps under {SHORT_GAP_US:g} us"
    for a, b in stretch.idle_gaps():
        if b - a < SHORT_GAP_US:
            label = short
        else:
            label, width = "no host op (Python code, or a wait)", float("inf")
            i = bisect.bisect_right(starts, a)
            for h_start, h_end, h_name in stretch.host[max(0, i - 4000):i]:
                if h_end >= a and h_end - h_start < width:
                    label, width = h_name, h_end - h_start
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    rank = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def roofline_pct(stretch: Stretch, patterns, ops) -> float | None:
    """Share of the bound: the bound of the stretch's operations
    (``ops(config, training, bx, by)``: (bytes, operations) per operation of
    a step) over the summed device time of the kernels whose names hold one
    of ``patterns``; None where no such kernel ran."""
    spent = sum(dur for name, _ts, dur in stretch.device if any(p in name for p in patterns))
    if spent <= 0:
        return None
    dtype = stretch.config["dtype"]
    bound = sum(n * counts.bound_s(b, f, dtype) for training, n, bx, by in stretch.steps
                for b, f in ops(stretch.config, training, bx, by))
    return 100.0 * bound * 1e6 / spent


def load_reader(name: str):
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(ROOT, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
