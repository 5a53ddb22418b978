"""The readings that a cell's limits are set from, in one process on the
card (no measured window: the three compared steps only):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control] [--fault half_batch] [--out FILE]

For each seed: the program's gaps to the reference (the lower readings);
with ``--control``, the gaps of the control, the reference itself with every
conv operand rounded to float8 e4m3 (the precision below the
configuration's bf16: ``steps.fp8``); with ``--fault``, the gaps of the program with that
fault planted (``portbench.faults``). One JSON line per reading on standard
output, and in ``--out`` when given.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path = [os.path.dirname(HERE)] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

from portbench import cells, checks, faults  # noqa: E402
from portbench.reference import steps  # noqa: E402


def program_readings(cell, seed, device, plant=None) -> dict:
    import torch
    inputs = cells.program_inputs(cell, seed, device)
    trainer = cells.make_trainer(cell, seed, device)
    if plant is not None:
        plant(trainer)
    c = cell["config"]
    with checks.Snapshots(trainer, cells.model(c).trained(c)) as snap:
        first = cells.run_epoch(trainer, inputs, 0, True)
    del trainer, inputs, snap.trainer
    gc.collect()
    torch.cuda.empty_cache()
    return snap.readings(first, checks.start_weights(cell, seed, device),
                         cell["config"]["beta_1"])


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true", help="read the control (steps.fp8)")
    p.add_argument("--fault", action="append", default=[], choices=sorted(faults.FAULTS))
    p.add_argument("--out", default=None)
    p.add_argument("--checked-seeds", type=int, default=1 << 30,
                   help="read the control and the faults on the first N seeds only")
    p.add_argument("--details", action="store_true", help="every candidate number and the "
                   "leaves that read worst")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    from gan_tpu_torch.ops import build
    build.build()
    cell = cells.load(args.workload)
    if cell["storage"] == "files":
        from gan_tpu_torch.data import native
        native.build()
    out = open(args.out, "a") if args.out else None

    def emit(seed, kind, got, ref, t):
        readings = checks.gaps(got, ref)
        line = {"cell": cell["name"], "seed": seed, "kind": kind,
                **{k: v for k, (v, _w) in readings.items()},
                "where": {k: w for k, (_v, w) in readings.items()},
                "seconds": round(time.perf_counter() - t, 3)}
        if args.details:
            line["details"] = checks.details(got, ref)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        ref = checks.reference_readings(cell, seed, device)
        emit(seed, "program", program_readings(cell, seed, device), ref, t)
        if args.control and i < args.checked_seeds:
            t = time.perf_counter()
            emit(seed, "control_fp8", checks.reference_readings(cell, seed, device, q=steps.fp8),
                 ref, t)
        for name in args.fault if i < args.checked_seeds else ():
            t = time.perf_counter()
            emit(seed, name, program_readings(cell, seed, device, faults.FAULTS[name]), ref, t)
    print(f"calibrate: {time.perf_counter() - T0:.1f} s, {torch.cuda.get_device_name(0)}",
          file=sys.stderr)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
