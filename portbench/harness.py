"""One run of one cell: set-up, the measured window of whole epochs, the
traced stretch where asked, and the comparison that decides ``correct``;
its result is one JSON line (README.md beside this file).

Set-up: the kernels' library (and the native decoder for a file cell) is
built or reused in ``gan_tpu_torch/build``; the weights and the rows are
made from the seed on the card; the trainer is built through its public
constructor and loaded with the weights; then one whole epoch (train, val)
runs outside the window, which captures the epoch runners' CUDA graphs and
runs the eager tail shapes, and whose first three train steps are the ones
compared. The window then runs whole epochs, as ``fit``'s epoch body runs
them, until ``--seconds`` have passed; with ``--trace 1`` one more whole
epoch runs under the profiler.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np

from portbench import cells, checks, counts, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "gan_tpu")


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = cells.load(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found {found}; "
              "nothing is measured", file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


def _metric_specs(cell: dict) -> tuple[list, list]:
    """(end-to-end, per-layer) entries of BENCHMARK.json that this cell reports."""
    bench = cells.benchmark()
    mine = lambda m: "workloads" not in m or cell["name"] in m["workloads"]
    return [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def run(cell: dict, seed: int, seconds: float, traced: bool, device, t0: float,
        plant: Optional[Callable] = None) -> Optional[dict]:
    """The result of one run, or None where it must print none. ``plant``
    breaks the trainer for the checks' tests; a run of the CLI plants
    nothing. On a device other than the card the device's numbers are not
    taken (its peak is reported as 0, and no share of a peak is read)."""
    import torch
    on_card = device.type == "cuda"
    c = cell["config"]
    marks = [("start", t0), ("imports", time.perf_counter())]
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        from gan_tpu_torch.ops import build
        build.build()
        if cell["storage"] == "files":
            from gan_tpu_torch.data import native
            native.build()
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    marks.append(("build", time.perf_counter()))
    inputs = cells.program_inputs(cell, seed, device)
    sync()
    marks.append(("inputs", time.perf_counter()))
    trainer = cells.make_trainer(cell, seed, device, marks=marks)
    if plant is not None:
        plant(trainer)
    sync()
    marks.append(("weights loaded", time.perf_counter()))
    with checks.Snapshots(trainer, cells.model(c).trained(c)) as snap:
        first = cells.run_epoch(trainer, inputs, 0, True)
    marks.append(("train epoch 0", time.perf_counter()))
    cells.run_epoch(trainer, inputs, 0, False)
    sync()
    marks.append(("val epoch 0", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                                 in zip(marks, marks[1:])), file=sys.stderr)

    n = cells.counts(cell)
    train_steps = counts.epoch_steps(c, n[0], n[1])
    epoch_pairs = cells.model(c).epoch_pairs(c, n)
    epoch_flops = sum(k * counts.step_flops(c, True, bx, by) for k, bx, by in train_steps)
    attempted = failed = 0
    untraced = []
    holder: dict = {}

    def whole_epoch(epoch: int) -> None:
        nonlocal attempted, failed
        for training in (True, False):
            losses = cells.run_epoch(trainer, inputs, epoch, training)
            attempted += len(losses)
            failed += int((~np.isfinite(losses).all(axis=1)).sum())

    epoch, w0 = 1, time.perf_counter()
    while True:
        t = time.perf_counter()
        whole_epoch(epoch)
        untraced.append(time.perf_counter() - t)
        epoch += 1
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    if traced:
        with trace.profiled(cell["name"], holder):
            whole_epoch(epoch)
    print(f"window: {len(untraced)} epochs in {window_s:.3f} s: "
          + " ".join(f"{t:.3f}" for t in untraced), file=sys.stderr)

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return None
    del trainer, inputs, snap.trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    e2e_specs, layer_specs = _metric_specs(cell)
    metrics, extra = {}, {}
    dev = {"platform": "gpu" if on_card else "cpu", "count": cell["chips"],
           "kind": torch.cuda.get_device_name(device) if on_card else "no card (a test's stub)",
           "memory_peak_bytes": int(peak)}
    if not traced:
        values = {"train_pairs_per_s": epoch_pairs * len(untraced) / window_s,
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e_specs}
    else:
        val_steps = counts.epoch_steps(c, n[2], n[3])
        t = time.perf_counter()
        stretch = trace.load(holder["events"], c,
                             [(True, k, bx, by) for k, bx, by in train_steps]
                             + [(False, k, bx, by) for k, bx, by in val_steps],
                             {"seconds": window_s, "train_flops": epoch_flops * len(untraced)}
                             if on_card else {})
        for m in layer_specs:
            value = trace.load_reader(m["name"])(stretch)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = stretch.busy_us() / 1e6
        dev["window_s"] = stretch.seconds
        extra["breakdown"] = trace.breakdown(stretch)
        by_group: dict = {}
        for name, _ts, dur in stretch.device:
            by_group[trace.group(name)] = by_group.get(trace.group(name), 0.0) + dur / 1e6
        print("device seconds by group: " + ", ".join(
            f"{g} {v:.4f}" for g, v in sorted(by_group.items(), key=lambda kv: -kv[1])),
            file=sys.stderr)
        print(f"trace: {len(holder['events'])} events, read {holder['read_s']:.1f} s, Chrome "
              f"trace written in {holder['write_s']:.1f} s, reduced in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    if on_card:
        dev["power"] = _power_limit()

    prog = snap.readings(first, checks.start_weights(cell, seed, device), c["beta_1"])
    readings = checks.gaps(prog, checks.reference_readings(cell, seed, device))
    limits = cell["limits"]
    correct = failed == 0 and checks.verdict(readings, limits)   # a NaN reading fails too
    compared = {k: {"value": v, "limit": limits[k]} for k, (v, _where) in readings.items()}
    compared["failed_steps"] = {"value": failed, "limit": 0}
    if forbidden_modules():
        print(f"portbench: the run loaded {forbidden_modules()}; no result", file=sys.stderr)
        return None
    for k, (v, where) in readings.items():
        print(f"check {k}: {v:.6g} (limit {limits[k]:g}; at {where})", file=sys.stderr)
    print(f"check failed_steps: {failed} (limit 0; of {attempted})", file=sys.stderr, flush=True)
    return {"correct": bool(correct),
            "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev,
            **extra, "checks": compared}
