#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name; TF32
   off for the fp32 comparisons;
2. build the CUDA kernels from ``gan_tpu_torch/csrc`` with nvcc (sm_90a);
3. the instance-norm forward kernel (K1) against its plain PyTorch version
   at every instance-norm shape of the 256² generator at batch 16, in fp32
   and bf16, for each activation epilogue, with the device time of both
   (CUDA graph replays timed with CUDA events), of ``F.instance_norm``
   (``F.group_norm`` at H·W = 1, which ``F.instance_norm`` refuses) and the
   bound;
4. the predict slice: the port's CycleGAN trainer at 256², depth 8, bf16,
   from seeded random weights, saved and restored through its checkpoint
   manager as ``--predict`` does, runs ``generate_batched`` on 32 seeded
   uint8 images; K1's launch count must be 14 per generator pass, and the
   output must agree with the same model run with the plain instance norm;
5. torch.profiler over 5 generator forwards, kernel and plain path: device
   time by kernel group, and the card's idle share of the eager forward;
6. the backward kernel (K2), and K1, against their plain versions at every
   instance-norm shape of a training step (the generator's and the
   PatchGAN's) at batch 8, in fp32 and bf16, with the device time of K2, of
   its plain version, of the autograd backward of ``F.instance_norm`` and
   the bound;
7. the training slice: ``CycleGANTrainer.fit`` for one epoch at 256², depth
   8, bf16, batch 8 on seeded uint8 caches (84 X and 88 Y images of 286²,
   16 + 16 val), with K1 and K2 launch counts derived from the step's
   structure (``train_step_launches``), a checkpoint round trip of all four
   networks and Adams, and one step's losses and gradients through the
   kernels against the same step through the plain instance norm;
8. the training numbers: the median step time, kernel and plain path in
   alternating rounds, image-pairs/s, peak device memory, and a
   torch.profiler breakdown of two steps with the card's idle share.

The last lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. No PNGs are written.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from gan_tpu_torch.config import parse_cyclegan
from gan_tpu_torch.data.augment import normalize_batch, single_jitter_batch
from gan_tpu_torch.models import blocks
from gan_tpu_torch.models.unet import _DOWN_FILTERS, _UP_SPECS
from gan_tpu_torch.ops import build, kernels, norm
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import NETWORKS, CycleGANTrainer, generator_depth

IMG_SIZE = 256
BATCH = 16          # generate_batched's chunk
N_IMAGES = 32       # two generator passes
TRAIN_BATCH = 8     # the README's CycleGAN quick start
# training caches: 84 X rows make 10 full steps and a zip tail of 4 X and 8 Y rows
N_TRAIN_X, N_TRAIN_Y, N_VAL = 84, 88, 16
SEED = 123
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA's data sheet
# Kernel vs plain, per call. fp32: Welford vs two-pass fp32 sums. bf16: the
# same fp32 statistics from the same bf16 inputs; the one output rounding may
# land one bf16 ulp apart (2^-7 relative). K2's dx alike.
KERNEL_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}   # (atol, rtol)


def sums_tol(count: int) -> float:
    """K2's dscale and doffset: fp32 sums of ``count`` = N·H·W terms, each
    thread's share summed in order, so the error grows with the count."""
    return 1e-5 + 1e-7 * count


# Whole generator, kernel vs plain norm, at the tanh output. bf16: one-ulp
# flips in the norm output pass through 15 convs and 13 more norms; a CPU run
# at depth 6-7 with float64 statistics in place of fp32 drifted by at most
# 0.006 (mean 7e-4); the bound is 8x that. fp32 (TF32 off): sum-order noise.
SLICE_TOL = {"bf16": (0.05, 5e-3), "fp32": (1e-3, 1e-5)}   # (max abs, mean abs)
# One train step, kernel vs plain norm, from the same state and draws: the 7
# losses (relative error) and each network's gradient (relative L2 error).
# bf16: one-ulp flips in the norms' outputs and dx pass through 6 U-Nets, 4
# PatchGANs and their backward, and move ReLU/LeakyReLU inputs near 0 to the
# other slope; either path's bf16 gradients differ from the fp32 ones by
# 7-14% (a CPU run at 32²). fp32 (TF32 off): on the CPU, fp32 sums in another
# order gave 3e-3 at a step where one LeakyReLU input took the other slope.
STEP_TOL = {"bf16": (2e-2, 2e-1), "fp32": (1e-4, 1e-2)}   # (losses, gradients)
# bf16 against fp32: the kernel path's error at most this factor of the plain
# path's, plus the slack (the two share the convs' bf16 rounding)
BF16_FACTOR, BF16_SLACK = 1.5, 1e-3
KERNEL_SOURCE = "gan_tpu_torch/csrc/instance_norm.cu"
REPLACES = {"instance_norm_fwd": "gan_tpu/ops/pallas_kernels.py:89",
            "instance_norm_bwd": "gan_tpu/ops/pallas_kernels.py:128"}
DISC_NORM_SITES = ((64, 128), (32, 256), (31, 512))   # the PatchGAN's at 256²


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def norm_sites(img_size: int, depth: int) -> list[tuple[int, int]]:
    """(H = W, C) of each instance norm in the generator, in call order."""
    down = [(img_size >> (i + 1), f) for i, f in enumerate(_DOWN_FILTERS[:depth])][1:]
    up_specs = _UP_SPECS[len(_UP_SPECS) - (depth - 1):]
    up = [(img_size >> (depth - 1 - i), f) for i, (f, _drop) in enumerate(up_specs)]
    return down + up


def train_step_launches(gen_norms: int, disc_norms: int) -> tuple[int, int]:
    """(K1, K2) launches of one CycleGAN train step, from its structure.

    K1: every norm of the 6 generator and 4 discriminator forwards. K2: one
    backward through every norm on a path from a network's total to its own
    parameters; each ``autograd.grad`` walks its own graph:
      gen_g: D_y(fake_y), G(x), F(fake_y) back to fake_y, G(fake_x), G(y);
      gen_f: D_x(fake_x), F(y), G(fake_x) back to fake_x, F(fake_y), F(x);
      disc_x, disc_y: D on the real and on the fake batch (stopping at it).
    """
    return 6 * gen_norms + 4 * disc_norms, 2 * (4 * gen_norms + disc_norms) + 2 * 2 * disc_norms


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
    calls where it fits, as it does after the conv that writes it. Warm-up
    runs on a side stream, as capturing an autograd backward requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = median_ms(graph.replay, reps=5) / calls
    del graph
    return ms


def bound_ms(nbytes: int) -> float:
    """The least time to move ``nbytes`` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _library_norm(x, weight, bias):
    """One PyTorch call for the instance norm of an NCHW tensor:
    ``F.instance_norm``, or at H·W = 1, which it refuses, ``F.group_norm``
    with one channel a group (the same function)."""
    if x.shape[2] * x.shape[3] == 1:
        return F.group_norm(x, x.shape[1], weight=weight, bias=bias, eps=norm.IN_EPS)
    return F.instance_norm(x, weight=weight, bias=bias, eps=norm.IN_EPS)


def library_fwd(x, scale, offset):
    """K1's function through the library, on the NCHW view of the NHWC
    tensor (channels-last memory)."""
    return _library_norm(x.permute(0, 3, 1, 2), scale.to(x.dtype), offset.to(x.dtype))


def library_bwd_ms(x, scale, offset, dy) -> float:
    """Device time of the library's autograd backward for ``dy``: forward and
    backward captured together, less the forward alone (a backward is
    captured only with its forward)."""
    xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
    sl = scale.to(x.dtype, copy=True).requires_grad_()
    ol = offset.to(x.dtype, copy=True).requires_grad_()
    dyl = dy.permute(0, 3, 1, 2)

    def fwd_bwd():
        return torch.autograd.grad(_library_norm(xl, sl, ol), (xl, sl, ol), dyl)

    with torch.no_grad():
        fwd = device_ms(lambda: _library_norm(xl, sl, ol))
    return device_ms(fwd_bwd) - fwd


def check_kernel(sites) -> dict:
    """Phase 3. Returns per-shape times and the largest error."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = sorted(set(sites))
    times, worst = {}, 0.0
    print(f"{'N,H,W,C':>18} {'dtype':>9} {'act':>10} {'max_abs_err':>12} {'tol(atol,rtol)':>16}"
          f" {'kernel_us':>10} {'plain_us':>10} {'library_us':>10} {'bound_us':>9}")
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
                lib_ms = b_ms = float("nan")
                if act is None:
                    lib_ms = device_ms(lambda: library_fwd(x, scale, offset))
                    b_ms = bound_ms(2 * x.numel() * x.element_size())
                times[(hw, c, dtype, act)] = (k_ms, p_ms, lib_ms, b_ms)
                print(f"{f'{BATCH},{hw},{hw},{c}':>18} {str(dtype)[6:]:>9} {str(act):>10} "
                      f"{err:>12.3e} {f'{atol:g},{rtol:g}':>16} {k_ms * 1e3:>10.2f} "
                      f"{p_ms * 1e3:>10.2f} {lib_ms * 1e3:>10.2f} {b_ms * 1e3:>9.2f}", flush=True)
    return {"times": times, "max_abs_err": worst}


def check_backward(shapes) -> dict:
    """Phase 6: K2 (and K1) against the plain versions at batch 8. Returns
    per-shape K2 times and the largest error."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    times, worst = {}, 0.0
    print(f"{'N,H,W,C':>18} {'dtype':>9} {'dx_err':>10} {'dscale_err':>10} {'doffset_err':>11}"
          f" {'tol(dx;sums)':>20} {'k1_err':>9} {'kernel_us':>10} {'plain_us':>10}"
          f" {'library_us':>10} {'bound_us':>9}")
    for hw, c in shapes:
        shape = (TRAIN_BATCH, hw, hw, c)
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device="cuda", generator=g) * 3.0 + 1.0).to(dtype)
            scale = 1.0 + 0.02 * torch.randn(c, device="cuda", generator=g)
            offset = 0.1 * torch.randn(c, device="cuda", generator=g)
            dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
            got = kernels.instance_norm_backward(x, scale, dy)
            y = kernels.instance_norm(x, scale, offset)
            torch.cuda.synchronize()
            want = norm.instance_norm_backward(x, scale, dy)
            atol, rtol = KERNEL_TOL[dtype]
            s_tol = sums_tol(TRAIN_BATCH * hw * hw)
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=rtol)
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, atol=s_tol, rtol=1e-5)
            y_want = norm.instance_norm(x, scale, offset)
            torch.testing.assert_close(y.float(), y_want.float(), atol=atol, rtol=rtol)
            errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
            k1_err = (y.float() - y_want.float()).abs().max().item()
            worst = max(worst, *errs)
            k_ms = device_ms(lambda: kernels.instance_norm_backward(x, scale, dy))
            p_ms = device_ms(lambda: norm.instance_norm_backward(x, scale, dy))
            lib_ms = library_bwd_ms(x, scale, offset, dy)
            b_ms = bound_ms(3 * x.numel() * x.element_size())
            times[(hw, c, dtype)] = (k_ms, p_ms, lib_ms, b_ms)
            print(f"{','.join(map(str, shape)):>18} {str(dtype)[6:]:>9} {errs[0]:>10.3e} "
                  f"{errs[1]:>10.3e} {errs[2]:>11.3e} {f'{atol:g},{rtol:g};{s_tol:.3g}':>20} "
                  f"{k1_err:>9.2e} {k_ms * 1e3:>10.2f} {p_ms * 1e3:>10.2f} {lib_ms * 1e3:>10.2f} "
                  f"{b_ms * 1e3:>9.2f}", flush=True)
    return {"times": times, "max_abs_err": worst}


def offsets_from_seed(trainer: CycleGANTrainer) -> None:
    """Seeded non-zero norm offsets: at init they are 0, and instance norm at
    H·W = 1 returns the offset exactly, so the bottleneck would carry nothing."""
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name in NETWORKS:
            for pname, p in trainer.nets[name].named_parameters():
                if pname.endswith("offset"):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))


def compare(name: str, got: np.ndarray, want: np.ndarray, tol) -> None:
    d = np.abs(got - want)
    mx, mean = float(d.max()), float(d.mean())
    print(f"{name}: max_abs_err {mx:.3e} (tol {tol[0]:g}), mean_abs_err {mean:.3e} (tol {tol[1]:g})")
    if not (mx <= tol[0] and mean <= tol[1]):
        raise AssertionError(f"{name}: kernel path disagrees with the plain path")


def plain_norm(label: str):
    """The blocks' instance norm as the plain version ('plain') or as is."""
    return (mock.patch.object(blocks, "instance_norm", norm.instance_norm)
            if label == "plain" else contextlib.nullcontext())


# kernel groups of the profile, by substring of the kernel name; first match wins
_GROUPS = (("instance norm forward (CUDA kernel K1)", ("instance_norm_fwd_kernel",)),
           ("instance norm backward (CUDA kernel K2)", ("instance_norm_bwd_kernel",)),
           ("Adam (multi-tensor)", ("multi_tensor_apply",)),
           ("dtype casts and copies", ("copy_kernel",)),
           ("cat of skips", ("CatArrayBatchedCopy",)),
           ("cuDNN convs, transposed convs and their layout kernels",
            ("xmma", "cutlass", "cudnn", "conv", "Nhwc", "Nchw", "wgrad", "dgrad")))


def profile_device(fn, calls: int) -> float:
    """Device µs per call by kernel group, from a torch.profiler trace of
    ``calls`` calls; prints the groups and the 8 longest kernels and returns
    the summed kernel time per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    groups, kernels_us, launched = {}, {}, 0
    for e in prof.events():
        # device-side ranges of annotations (Optimizer.step#Adam.step) span
        # kernels counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("Optimizer.")):
            continue
        us = e.time_range.elapsed_us() / calls
        launched += 1
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
    print(f"  {launched / calls:10.1f} device kernels and copies per call")
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
    print(f"launches on the predict path: {launches} over {passes} generator passes")
    if launches != {"instance_norm_fwd": 14 * passes, "instance_norm_bwd": 0}:
        raise AssertionError(f"expected {14 * passes} K1 launches and no K2, got {launches}")
    want_sites = {(hw, hw, c) for hw, c in norm_sites(IMG_SIZE, depth)}
    if seen != want_sites:
        raise AssertionError(f"instance-norm shapes {sorted(seen)} != compared {sorted(want_sites)}")
    if pred.shape != (N_IMAGES, IMG_SIZE, IMG_SIZE, 1) or pred.dtype != np.float32:
        raise AssertionError(f"output {pred.shape} {pred.dtype}")
    if not (np.isfinite(pred).all() and np.abs(pred).max() <= 1.0):
        raise AssertionError("output not finite or outside [-1, 1]")
    print(f"output {pred.shape} in [{pred.min():.4f}, {pred.max():.4f}], std {pred.std():.4f}")

    with plain_norm("plain"):
        plain = trainer.generate_batched(u8, chunk=BATCH)
    compare("bf16 slice, kernel vs plain instance norm", pred, plain, SLICE_TOL["bf16"])

    # the same weights in fp32 (TF32 off): kernel and plain paths agree closely
    trainer32 = CycleGANTrainer(parse_cyclegan(argv[:-1] + ["fp32"]))
    trainer32.load_state(trainer.state())
    k32 = trainer32.generate_batched(u8[:4], chunk=4)
    with plain_norm("plain"):
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

    fwd_runs = {"kernel": [], "plain": []}
    for order in (("kernel", "plain"), ("plain", "kernel")) * 4:
        for label in order:
            with plain_norm(label):
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
        with plain_norm(label):
            busy_us = profile_device(fwd, 5)
        eager_ms = float(np.median(fwd_runs[label]))
        print(f"  {busy_us:10.2f} us  sum of kernel time; eager forward median {eager_ms:.3f} ms, "
              f"so the card is idle {1 - busy_us / 1e3 / eager_ms:.1%} of it")
    return launches


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def check_step_paths(bf16: CycleGANTrainer, fp32: CycleGANTrainer, x, y) -> None:
    """One step's losses and per-network gradients from the same state,
    batch and dropout draws, through the kernels and through the plain
    instance norm, in fp32 (TF32 off) and bf16; nothing is updated. fp32:
    kernel path against plain path. bf16: each path against the fp32 plain
    path, and the kernel path no further from it than the plain path is,
    within a factor (bf16 rounding in the convs is common to both)."""
    def draws():
        return [bf16._draws(SEED, 0, 0, 0, app) for app in range(6)]

    runs = {}
    for label, trainer, xs, ys in (("bf16", bf16, x, y), ("fp32", fp32, x.float(), y.float())):
        for path in ("kernel", "plain"):
            with plain_norm(path):
                grads, losses = trainer.gradients(xs, ys, draws())
            runs[label, path] = ({k: torch.cat([g.flatten().float() for g in v])
                                  for k, v in grads.items()}, losses)
    ref_grads, ref_losses = runs["fp32", "plain"]

    def errs(key, against=("fp32", "plain")):
        grads, losses = runs[key]
        want_grads, want_losses = runs[against]
        loss_err = ((losses - want_losses).abs() / want_losses.abs()).max().item()
        return loss_err, {k: _rel(grads[k], want_grads[k]) for k in NETWORKS}

    fmt = lambda d: {k: f"{v:.3e}" for k, v in d.items()}
    l32, g32 = errs(("fp32", "kernel"))
    print(f"fp32 step, kernel vs plain path: losses {runs['fp32', 'kernel'][1].tolist()} vs "
          f"{ref_losses.tolist()}, max relative error {l32:.3e} (tol {STEP_TOL['fp32'][0]:g}); "
          f"gradient relative L2 error {fmt(g32)} (tol {STEP_TOL['fp32'][1]:g})")
    (lk, gk), (lp, gp) = errs(("bf16", "kernel")), errs(("bf16", "plain"))
    lkp, gkp = errs(("bf16", "kernel"), ("bf16", "plain"))
    print(f"bf16 step against the fp32 plain path: kernel path losses {lk:.3e}, gradients "
          f"{fmt(gk)}; plain path losses {lp:.3e}, gradients {fmt(gp)} (tol: the kernel path's "
          f"errors at most {BF16_FACTOR:g}x the plain path's + {BF16_SLACK:g}); kernel vs plain "
          f"path: losses {lkp:.3e} (tol {STEP_TOL['bf16'][0]:g}), gradients {fmt(gkp)} "
          f"(tol {STEP_TOL['bf16'][1]:g})")
    ok32 = l32 <= STEP_TOL["fp32"][0] and max(g32.values()) <= STEP_TOL["fp32"][1]
    ok16 = (lkp <= STEP_TOL["bf16"][0] and max(gkp.values()) <= STEP_TOL["bf16"][1]
            and lk <= BF16_FACTOR * lp + BF16_SLACK
            and all(gk[k] <= BF16_FACTOR * gp[k] + BF16_SLACK for k in NETWORKS))
    if not (ok32 and ok16):
        raise AssertionError("train step: kernel path disagrees with the plain path")


def run_training(tmp: str) -> dict:
    """Phases 7 and 8. Returns the kernel launch counts of the main-path run."""
    argv = ["--input-images", tmp, "--target-images", tmp, "--output", tmp, "--train",
            "--epochs", "1", "--img-size", str(IMG_SIZE), "--batch-size", str(TRAIN_BATCH),
            "--dtype", "bf16"]
    cfg = parse_cyclegan(argv)
    trainer = CycleGANTrainer(cfg)
    offsets_from_seed(trainer)
    sizes = {k: sum(p.numel() for p in v) / 1e6 for k, v in trainer.params.items()}
    print(f"networks (M parameters): {sizes}")
    rng = np.random.default_rng(SEED + 3)
    pad = IMG_SIZE + 30
    train_x = rng.integers(0, 256, (N_TRAIN_X, pad, pad, 1), dtype=np.uint8)
    train_y = rng.integers(0, 256, (N_TRAIN_Y, pad, pad, 1), dtype=np.uint8)
    val_x, val_y, test = (rng.integers(0, 256, (n, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8)
                          for n in (N_VAL, N_VAL, 1))
    before = {k: [p.detach().clone() for p in v] for k, v in trainer.params.items()}
    mgr = CheckpointManager(os.path.join(tmp, "training_checkpoints"), max_to_keep=3)

    bwd_calls = [0]
    real_backward = kernels.InstanceNormFunction.backward

    def counted_backward(ctx, dy):
        bwd_calls[0] += 1
        return real_backward(ctx, dy)

    train_steps = -(-min(N_TRAIN_X, N_TRAIN_Y) // TRAIN_BATCH)
    val_steps = -(-N_VAL // TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with mock.patch.object(kernels.InstanceNormFunction, "backward", staticmethod(counted_backward)):
        t0 = time.perf_counter()
        train_cost, val_cost = trainer.fit(train_x, train_y, val_x, val_y, test, tmp,
                                           checkpoint_manager=mgr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1, k2 = train_step_launches(len(norm_sites(IMG_SIZE, generator_depth(IMG_SIZE))),
                                 len(DISC_NORM_SITES))
    want = {"instance_norm_fwd": (train_steps + val_steps) * k1,
            "instance_norm_bwd": train_steps * k2}
    print(f"fit, 1 epoch of {train_steps} train steps (the last a zip tail of "
          f"{N_TRAIN_X - (train_steps - 1) * TRAIN_BATCH} X and {TRAIN_BATCH} Y rows) and "
          f"{val_steps} val steps: {fit_s:.2f} s with the first step's set-up; launches on "
          f"the training path {launches}, expected {want} ({k1} K1 and {k2} K2 per train step, "
          f"{k1} K1 per val step); InstanceNormFunction.backward calls {bwd_calls[0]}; "
          f"peak device memory {peak:.2f} GiB")
    if launches != want or bwd_calls[0] != want["instance_norm_bwd"]:
        raise AssertionError("launch counts differ from the step's derivation")
    for k in train_cost:
        print(f"  {k}: train {train_cost[k][0]:.4f}, val {val_cost[k][0]:.4f}")
    if not all(math.isfinite(v[0]) for d in (train_cost, val_cost) for v in d.values()):
        raise AssertionError("a loss is not finite")
    unchanged = [k for k in NETWORKS
                 if all(torch.equal(a, b) for a, b in zip(before[k], trainer.params[k]))]
    if unchanged:
        raise AssertionError(f"fit left {unchanged} unchanged")
    del before

    restored = CycleGANTrainer(cfg)
    # on the CPU: the Adams keep their step counts there, and move the moments to the card
    restored.load_state(mgr.restore(map_location="cpu"))
    for name in NETWORKS:
        for (ka, a), (kb, b) in zip(trainer.nets[name].state_dict().items(),
                                    restored.nets[name].state_dict().items()):
            if ka != kb or not torch.equal(a, b):
                raise AssertionError(f"checkpoint round trip changed {name}.{ka}")
        sa, sb = trainer.opts[name].state_dict(), restored.opts[name].state_dict()
        if sa["param_groups"] != sb["param_groups"] or sa["state"].keys() != sb["state"].keys():
            raise AssertionError(f"checkpoint round trip changed {name}'s Adam")
        for i, st in sa["state"].items():
            if not all(torch.equal(v.cpu(), sb["state"][i][k].cpu()) for k, v in st.items()):
                raise AssertionError(f"checkpoint round trip changed {name}'s Adam state {i}")
    steps = int(sa["state"][0]["step"])
    print(f"checkpoint {mgr.all_epochs()}: 4 networks and 4 Adams (step {steps}) restored equal")
    if steps != train_steps:
        raise AssertionError(f"Adam took {steps} steps, expected {train_steps}")
    del restored

    # one step from the fitted state, kernel path vs plain path
    u8x = torch.from_numpy(train_x[:TRAIN_BATCH]).to("cuda")
    u8y = torch.from_numpy(train_y[:TRAIN_BATCH]).to("cuda")
    gx, gy = (torch.Generator(device="cuda").manual_seed(SEED + i) for i in (4, 5))
    x = single_jitter_batch(u8x, gx, img_size=IMG_SIZE, dtype=torch.bfloat16)
    y = single_jitter_batch(u8y, gy, img_size=IMG_SIZE, dtype=torch.bfloat16)
    trainer32 = CycleGANTrainer(parse_cyclegan(argv[:-1] + ["fp32"]))
    trainer32.load_state(trainer.state())
    check_step_paths(trainer, trainer32, x, y)
    del trainer32

    phase(f"8. training numbers: train step at {IMG_SIZE}², bf16, batch {TRAIN_BATCH}, "
          "uint8 batch resident on the card")

    def step():   # what fit runs per step: draws, jitter, gradients, four Adam updates
        trainer._step(u8x, u8y, 0, 0, 0)

    step_runs = {"kernel": [], "plain": []}
    for order in (("kernel", "plain"), ("plain", "kernel")) * 3:
        for label in order:
            with plain_norm(label):
                step_runs[label].append(median_ms(step, reps=5))
    for label, runs_ms in step_runs.items():
        med = float(np.median(runs_ms))
        print(f"train step, {label} instance norm: median {med:.3f} ms "
              f"(rounds {[round(r, 3) for r in runs_ms]}), {TRAIN_BATCH / med * 1e3:.2f} image-pairs/s")
    print(f"peak device memory of fit {peak:.2f} GiB")
    for label in ("kernel", "plain"):
        print(f"{label} instance norm, device time per train step:")
        with plain_norm(label):
            busy_us = profile_device(step, 2)
        eager_ms = float(np.median(step_runs[label]))
        print(f"  {busy_us:10.2f} us  sum of kernel time; eager step median {eager_ms:.3f} ms, "
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

    phase("3. instance-norm forward kernel (K1) vs plain, predict shapes")
    sites = norm_sites(IMG_SIZE, generator_depth(IMG_SIZE))
    if len(sites) != 14:
        raise AssertionError(f"expected 14 instance-norm sites, got {sites}")
    k = check_kernel(sites)
    k1_pass = [sum(k["times"][(hw, c, torch.bfloat16, None)][i] for hw, c in sites)
               for i in range(4)]
    print(f"14 sites of one bf16 generator pass at batch {BATCH}: kernel {k1_pass[0] * 1e3:.2f} us, "
          f"plain {k1_pass[1] * 1e3:.2f} us, F.instance_norm {k1_pass[2] * 1e3:.2f} us, "
          f"bound {k1_pass[3] * 1e3:.2f} us")

    phase("4. CycleGAN predict slice")
    with tempfile.TemporaryDirectory() as tmp:
        predict_launches = run_slice(tmp)

    phase(f"6. instance-norm backward kernel (K2) vs plain, training shapes, batch {TRAIN_BATCH}")
    step_sites = sites + list(DISC_NORM_SITES)
    b = check_backward(sorted(set(step_sites)))
    k2_pass = [sum(b["times"][(hw, c, torch.bfloat16)][i] for hw, c in step_sites)
               for i in range(4)]
    print(f"{len(step_sites)} sites of one bf16 generator and one discriminator backward at batch "
          f"{TRAIN_BATCH}: kernel {k2_pass[0] * 1e3:.2f} us, plain {k2_pass[1] * 1e3:.2f} us, "
          f"F.instance_norm backward {k2_pass[2] * 1e3:.2f} us, bound {k2_pass[3] * 1e3:.2f} us")

    phase(f"7. CycleGAN training slice: fit at {IMG_SIZE}², bf16, batch {TRAIN_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = run_training(tmp)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[name],
         "launches": predict_launches[name] + train_launches[name], "max_abs_err": err,
         "ms": t[0], "plain_ms": t[1], "bound_ms": t[3], "bound_by": "bytes",
         "library_ms": t[2]}
        for name, err, t in (("instance_norm_fwd", k["max_abs_err"], k1_pass),
                             ("instance_norm_bwd", b["max_abs_err"], k2_pass))]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
