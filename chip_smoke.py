#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name; TF32
   off for the fp32 comparisons;
2. build the CUDA kernels from ``gan_tpu_torch/csrc`` with nvcc (sm_90a);
3. the instance-norm kernel against its plain PyTorch version at every
   instance-norm shape of the 256² generator at batch 16, in fp32 and bf16,
   for each activation epilogue, with the device time of both (CUDA graph
   replays timed with CUDA events);
4. the slice: the port's CycleGAN trainer at 256², depth 8, bf16, from
   seeded random weights, saved and restored through its checkpoint manager
   as ``--predict`` does, runs ``generate_batched`` on 32 seeded uint8
   images; the kernel's launch count must be 14 per generator pass, and the
   output must agree with the same model run with the plain instance norm;
5. torch.profiler over 5 generator forwards, kernel and plain path: device
   time by kernel group, and the card's idle share of the eager forward.

The last lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. No PNGs are written.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from gan_tpu_torch.config import parse_cyclegan
from gan_tpu_torch.models import blocks
from gan_tpu_torch.data.augment import normalize_batch
from gan_tpu_torch.models.unet import _DOWN_FILTERS, _UP_SPECS
from gan_tpu_torch.ops import build, kernels, norm
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer, generator_depth

IMG_SIZE = 256
BATCH = 16          # generate_batched's chunk
N_IMAGES = 32       # two generator passes
SEED = 123
# Kernel vs plain, per call. fp32: Welford vs two-pass fp32 sums. bf16: the
# same fp32 statistics from the same bf16 inputs; the one output rounding may
# land one bf16 ulp apart (2^-7 relative).
KERNEL_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}   # (atol, rtol)
# Whole generator, kernel vs plain norm, at the tanh output. bf16: one-ulp
# flips in the norm output pass through 15 convs and 13 more norms; a CPU run
# at depth 6-7 with float64 statistics in place of fp32 drifted by at most
# 0.006 (mean 7e-4); the bound is 8x that. fp32 (TF32 off): sum-order noise.
SLICE_TOL = {"bf16": (0.05, 5e-3), "fp32": (1e-3, 1e-5)}   # (max abs, mean abs)
KERNEL_SOURCE = "gan_tpu_torch/csrc/instance_norm.cu"
REPLACES = "gan_tpu/ops/pallas_kernels.py:89"


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def norm_sites(img_size: int, depth: int) -> list[tuple[int, int]]:
    """(H = W, C) of each instance norm in the generator, in call order."""
    down = [(img_size >> (i + 1), f) for i, f in enumerate(_DOWN_FILTERS[:depth])][1:]
    up_specs = _UP_SPECS[len(_UP_SPECS) - (depth - 1):]
    up = [(img_size >> (depth - 1 - i), f) for i, (f, _drop) in enumerate(up_specs)]
    return down + up


def median_ms(fn, reps: int = 10) -> float:
    """Median time of one eager call, CUDA events around it, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call, free of Python launch overhead: ``calls``
    back-to-back calls captured in a CUDA graph, the replay timed with CUDA
    events (median of 5), divided by ``calls``. The input stays in L2 between
    calls where it fits, as it does after the conv that writes it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = median_ms(graph.replay, reps=5) / calls
    del graph
    return ms


def check_kernel(sites) -> dict:
    """Phase 3. Returns per-shape times and the largest error."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = sorted(set(sites))
    times, worst = {}, 0.0
    print(f"{'N,H,W,C':>18} {'dtype':>9} {'act':>10} {'max_abs_err':>12} {'tol(atol,rtol)':>16}"
          f" {'kernel_us':>10} {'plain_us':>10}")
    for hw, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for act in norm.ACTS:
                x = (torch.randn(BATCH, hw, hw, c, device="cuda", generator=g) * 3.0 + 1.0).to(dtype)
                scale = 1.0 + 0.02 * torch.randn(c, device="cuda", generator=g)
                offset = 0.1 * torch.randn(c, device="cuda", generator=g)
                got = kernels.instance_norm(x, scale, offset, act=act)
                torch.cuda.synchronize()
                want = norm.instance_norm(x, scale, offset, act=act)
                err = (got.float() - want.float()).abs().max().item()
                atol, rtol = KERNEL_TOL[dtype]
                torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
                worst = max(worst, err)
                k_ms = device_ms(lambda: kernels.instance_norm(x, scale, offset, act=act))
                p_ms = device_ms(lambda: norm.instance_norm(x, scale, offset, act=act))
                times[(hw, c, dtype, act)] = (k_ms, p_ms)
                print(f"{f'{BATCH},{hw},{hw},{c}':>18} {str(dtype)[6:]:>9} {str(act):>10} "
                      f"{err:>12.3e} {f'{atol:g},{rtol:g}':>16} {k_ms * 1e3:>10.2f} {p_ms * 1e3:>10.2f}",
                      flush=True)
    return {"times": times, "max_abs_err": worst}


def offsets_from_seed(trainer: CycleGANTrainer) -> None:
    """Seeded non-zero norm offsets: at init they are 0, and instance norm at
    H·W = 1 returns the offset exactly, so the bottleneck would carry nothing."""
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for gen in (trainer.gen_g, trainer.gen_f):
            for name, p in gen.named_parameters():
                if name.endswith("offset"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))


def compare(name: str, got: np.ndarray, want: np.ndarray, tol) -> None:
    d = np.abs(got - want)
    mx, mean = float(d.max()), float(d.mean())
    print(f"{name}: max_abs_err {mx:.3e} (tol {tol[0]:g}), mean_abs_err {mean:.3e} (tol {tol[1]:g})")
    if not (mx <= tol[0] and mean <= tol[1]):
        raise AssertionError(f"{name}: kernel path disagrees with the plain path")


# kernel groups of the profile, by substring of the kernel name; first match wins
_GROUPS = (("instance norm (CUDA kernel)", ("instance_norm_fwd_kernel",)),
           ("dtype casts and copies", ("copy_kernel",)),
           ("cat of skips", ("CatArrayBatchedCopy",)),
           ("cuDNN convs, transposed convs and their layout kernels",
            ("xmma", "cutlass", "cudnn", "conv", "Nhwc", "Nchw")))


def profile_forward(fwd, forwards: int = 5) -> float:
    """Device µs per forward by kernel group, from a torch.profiler trace of
    ``forwards`` calls; prints the groups and the 8 longest kernels and
    returns the summed kernel time per forward."""
    from torch.profiler import ProfilerActivity, profile

    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            fwd()
        torch.cuda.synchronize()
    groups, kernels_us = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us() / forwards
        group = next((g for g, keys in _GROUPS if any(k in e.name for k in keys)),
                     "other elementwise and reductions")
        groups[group] = groups.get(group, 0.0) + us
        kernels_us[e.name] = kernels_us.get(e.name, 0.0) + us
    if not groups:
        raise AssertionError("the profiler recorded no device time")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {us:10.2f} us  {group}")
    for name, us in sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us:10.2f} us  {name[:100]}")
    return sum(groups.values())


def run_slice(tmp: str) -> dict:
    """Phases 4 and 5. Returns the kernel launch counts of the main-path run."""
    images, out, weights = (os.path.join(tmp, d) for d in ("x", "out", "run"))
    argv = ["--input-images", images, "--output", out, "--predict", "--weights", weights,
            "--img-size", str(IMG_SIZE), "--channels", "1", "--dtype", "bf16"]
    cfg = parse_cyclegan(argv)
    depth = generator_depth(cfg.img_size)
    seeded = CycleGANTrainer(cfg)
    offsets_from_seed(seeded)
    n_params = sum(p.numel() for p in seeded.gen_g.parameters())
    print(f"generator: depth {depth}, {n_params / 1e6:.2f} M parameters, device {seeded.device}")
    CheckpointManager(os.path.join(weights, "training_checkpoints"), max_to_keep=3).save(1, seeded.state())

    trainer = CycleGANTrainer(cfg)       # as --predict does: build, then restore
    trainer.load_state(CheckpointManager(latest_checkpoint_dir(weights)).restore(
        map_location=trainer.device))
    for a, b in zip(seeded.gen_g.state_dict().values(), trainer.gen_g.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError("checkpoint round trip changed the weights")
    del seeded

    seen = set()
    for m in trainer.gen_g.modules():
        if isinstance(m, blocks.InstanceNorm):
            m.register_forward_hook(lambda mod, inp, o: seen.add(tuple(inp[0].shape[1:])))
    u8 = np.random.default_rng(SEED).integers(0, 256, (N_IMAGES, IMG_SIZE, IMG_SIZE, 1),
                                              dtype=np.uint8)
    passes = -(-N_IMAGES // BATCH)

    kernels.reset_launches()
    pred = trainer.generate_batched(u8, chunk=BATCH)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the main path: {launches} over {passes} generator passes")
    if launches["instance_norm_fwd"] != 14 * passes:
        raise AssertionError(f"expected {14 * passes} instance-norm launches, got {launches}")
    want_sites = {(hw, hw, c) for hw, c in norm_sites(IMG_SIZE, depth)}
    if seen != want_sites:
        raise AssertionError(f"instance-norm shapes {sorted(seen)} != compared {sorted(want_sites)}")
    if pred.shape != (N_IMAGES, IMG_SIZE, IMG_SIZE, 1) or pred.dtype != np.float32:
        raise AssertionError(f"output {pred.shape} {pred.dtype}")
    if not (np.isfinite(pred).all() and np.abs(pred).max() <= 1.0):
        raise AssertionError("output not finite or outside [-1, 1]")
    print(f"output {pred.shape} in [{pred.min():.4f}, {pred.max():.4f}], std {pred.std():.4f}")

    with mock.patch.object(blocks, "instance_norm", norm.instance_norm):
        plain = trainer.generate_batched(u8, chunk=BATCH)
    compare("bf16 slice, kernel vs plain instance norm", pred, plain, SLICE_TOL["bf16"])

    # the same weights in fp32 (TF32 off): kernel and plain paths agree closely
    trainer32 = CycleGANTrainer(parse_cyclegan(argv[:-1] + ["fp32"]))
    trainer32.load_state(trainer.state())
    k32 = trainer32.generate_batched(u8[:4], chunk=4)
    with mock.patch.object(blocks, "instance_norm", norm.instance_norm):
        p32 = trainer32.generate_batched(u8[:4], chunk=4)
    compare("fp32 slice, kernel vs plain instance norm", k32, p32, SLICE_TOL["fp32"])
    del trainer32

    # end-to-end predict rate: host uint8 in, host fp32 out (7 runs, median)
    runs = []
    for _ in range(7):
        t0 = time.perf_counter()
        trainer.generate_batched(u8, chunk=BATCH)
        runs.append(time.perf_counter() - t0)
    e2e = float(np.median(runs))
    # one generator pass on a resident batch of 16, kernel and plain in turns
    x = normalize_batch(torch.from_numpy(u8[:BATCH]).to("cuda"), torch.bfloat16)
    gen = torch.Generator(device="cuda")

    def fwd():
        with torch.no_grad():
            trainer.gen_g(x, generator=gen.manual_seed(0), compute_dtype=torch.bfloat16)

    def instance_norm_of(label):
        return (mock.patch.object(blocks, "instance_norm", norm.instance_norm)
                if label == "plain" else contextlib.nullcontext())

    fwd_runs = {"kernel": [], "plain": []}
    for order in (("kernel", "plain"), ("plain", "kernel")) * 4:
        for label in order:
            with instance_norm_of(label):
                fwd_runs[label].append(median_ms(fwd))
    print(f"predict {N_IMAGES} images at {IMG_SIZE}² bf16: {e2e * 1e3:.2f} ms "
          f"(runs {[round(r * 1e3, 2) for r in runs]}), {N_IMAGES / e2e:.2f} images/s, "
          f"{e2e / passes * 1e3:.2f} ms per batch of {BATCH}")
    for label, runs_ms in fwd_runs.items():
        print(f"generator forward, batch {BATCH} resident on the card, {label} instance norm: "
              f"median {np.median(runs_ms):.3f} ms (rounds {[round(r, 3) for r in runs_ms]})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase(f"5. profile: generator forward, batch {BATCH} resident on the card")
    for label in ("kernel", "plain"):
        print(f"{label} instance norm, device time per forward:")
        with instance_norm_of(label):
            busy_us = profile_forward(fwd)
        eager_ms = float(np.median(fwd_runs[label]))
        print(f"  {busy_us:10.2f} us  sum of kernel time; eager forward median {eager_ms:.3f} ms, "
              f"so the card is idle {1 - busy_us / 1e3 / eager_ms:.1%} of it")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}\ntorch: {torch.__version__} CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    phase("2. build")
    path, seconds = build.build()
    print(f"built {os.path.relpath(path)} in {seconds:.2f} s (0 = reused)")
    with open(path + ".log") as f:
        print("".join(line for line in f if "registers" in line or "spill" in line), end="")

    phase("3. instance-norm kernel vs plain")
    sites = norm_sites(IMG_SIZE, generator_depth(IMG_SIZE))
    if len(sites) != 14:
        raise AssertionError(f"expected 14 instance-norm sites, got {sites}")
    k = check_kernel(sites)
    k_pass = sum(k["times"][(hw, c, torch.bfloat16, None)][0] for hw, c in sites)
    p_pass = sum(k["times"][(hw, c, torch.bfloat16, None)][1] for hw, c in sites)
    print(f"14 sites of one bf16 generator pass at batch {BATCH}: kernel {k_pass * 1e3:.2f} us, "
          f"plain {p_pass * 1e3:.2f} us")

    phase("4. CycleGAN predict slice")
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_slice(tmp)

    record = {"kernels": [{
        "name": "instance_norm_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches["instance_norm_fwd"],
        "max_abs_err": k["max_abs_err"], "ms": k_pass, "plain_ms": p_pass}]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
