#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name; TF32
   off for the fp32 comparisons;
2. build the CUDA kernels from ``gan_tpu_torch/csrc`` with nvcc (sm_90a);
3. the instance-norm forward kernel (K1) against its plain PyTorch version
   at every norm site of the 256² generator at batch 16, in fp32 and bf16,
   for each activation epilogue and with batch norm's epsilon (Pix2Pix's
   per-image batch norm), with each site's launch plan, the device time of
   both (CUDA graph replays timed with CUDA events), of the library
   (``F.instance_norm``, or ``F.group_norm`` at H·W = 1, which
   ``F.instance_norm`` refuses; followed by ``F.leaky_relu`` or ``F.relu``
   for an epilogue), the bound, the kernel's share of it and its ratio to
   the library; at the largest site, ``cudaOccupancyMaxActiveClusters``, the
   chosen plan against other geometries, and the chosen plan's per-block
   timeline;
4. the stem kernel (S) against its plain version at every stem shape the
   paths run, in fp32 and bf16, with the device time of both, of the library
   pair ``F.conv2d`` + ``F.leaky_relu`` and the bound; its backward (dx and
   dw through cuDNN) against autograd of the plain version at the training
   shapes;
5. the CycleGAN predict slice: the port's CycleGAN trainer at 256², depth 8,
   bf16, from seeded random weights, saved and restored through its
   checkpoint manager as ``--predict`` does, runs ``generate_batched`` on 32
   seeded uint8 images; K1 must launch 14 times and S once per generator
   pass, and the output must agree with the same model on the plain path
   (``plain_path``: S and K1 swapped for their plain versions); then
   torch.profiler over 5 generator forwards, kernel and plain path;
6. the backward kernel (K2), and K1, against their plain versions at every
   instance-norm shape of a CycleGAN training step at batch 8, with the
   same columns, plan sweep and timeline as phase 3;
7. the CycleGAN training slice: ``CycleGANTrainer.fit`` for one epoch at
   256², depth 8, bf16, batch 8 on seeded uint8 caches (84 X and 88 Y
   images of 286², 16 + 16 val), with K1, K2 and S launch counts derived from
   the step's structure, a checkpoint round trip of all four networks and
   Adams, and one step's losses and gradients through the kernels against
   the same step on the plain path;
8. the CycleGAN training numbers: the median step time, kernel and plain
   path in alternating rounds, image-pairs/s, peak device memory, and a
   torch.profiler breakdown of two steps with the card's idle share;
9. the Pix2Pix predict slice: ``Pix2PixTrainer`` at 256², depth 8, bf16,
   seeded weights with non-zero batch-norm betas, restored through the
   checkpoint manager, ``generate_batched`` on 32 seeded uint8 images with
   per-image batch norm: S once and K1 14 times per chunk, the output
   against the plain path;
10. the Pix2Pix training slice: ``Pix2PixTrainer.fit`` for one epoch at
    256², bf16, batch 32 (the README's Pix2Pix quick start) on seeded caches
    of 261 train pairs at 286² (8 full steps and a 5-row remainder) and 40
    val pairs (a full step and an 8-row remainder): 3 S launches per step
    and no K1 or K2, finite losses, both networks changed, a checkpoint round
    trip, and one step against the plain path;
11. the Pix2Pix training numbers, as in phase 8.

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

from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.data.augment import normalize_batch, paired_jitter_batch, single_jitter_batch
from gan_tpu_torch.models import blocks
from gan_tpu_torch.models.unet import _DOWN_FILTERS, _UP_SPECS
from gan_tpu_torch.ops import build, conv, kernels, norm
from gan_tpu_torch.train.base import generator_depth
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer
from gan_tpu_torch.train.pix2pix_trainer import Pix2PixTrainer

IMG_SIZE = 256
BATCH = 16          # generate_batched's chunk
N_IMAGES = 32       # two generator passes
TRAIN_BATCH = 8     # the README's CycleGAN quick start
# training caches: 84 X rows make 10 full steps and a zip tail of 4 X and 8 Y rows
N_TRAIN_X, N_TRAIN_Y, N_VAL = 84, 88, 16
P2P_BATCH = 32      # the README's Pix2Pix quick start
N_P2P_TRAIN, N_P2P_VAL = 261, 40   # 8 full steps + 5 rows; 1 full step + 8 rows
SEED = 123
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory, NVIDIA's data sheet
# dense peaks by input type, NVIDIA's data sheet: bf16 on the tensor cores,
# fp32 outside them (TF32 is off)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain, per call. fp32: Welford vs two-pass fp32 sums. bf16: the
# same fp32 statistics from the same bf16 inputs; the one output rounding may
# land one bf16 ulp apart (2^-7 relative). K2's dx alike.
KERNEL_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}   # (atol, rtol)
# S vs plain. fp32 (TF32 off): 16·C_in products summed in another order than
# cuDNN's. bf16: the same exact bf16 products summed in fp32; S rounds once
# after the LeakyReLU, the plain version rounds the conv and then the slope's
# product: one ulp plus that second rounding.
STEM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7 + 2 ** -8)}
# S's backward vs autograd of the plain version, relative L2 error of dx and
# dw: the same masked dy into cuDNN's convolution_backward; only where the
# two forwards' signs differ at 0 may the mask differ. fp32: sums in other
# orders; bf16: cuDNN may pick another algorithm for the other layouts.
STEM_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def sums_tol(count: int) -> float:
    """K2's dscale and doffset: fp32 sums of ``count`` = N·H·W terms, each
    thread's share summed in order, so the error grows with the count."""
    return 1e-5 + 1e-7 * count


# Whole generator, kernel vs plain path, at the tanh output. bf16: one-ulp
# flips in the norm and stem outputs pass through 15 convs and 13 more norms;
# a CPU run at depth 6-7 with float64 statistics in place of fp32 drifted by
# at most 0.006 (mean 7e-4); the bound is 8x that. fp32 (TF32 off): sum-order
# noise.
SLICE_TOL = {"bf16": (0.05, 5e-3), "fp32": (1e-3, 1e-5)}   # (max abs, mean abs)
# One train step, kernel vs plain path, from the same state and draws: the
# losses (relative error) and each network's gradient (relative L2 error).
# bf16: one-ulp flips in the kernels' outputs pass through the networks and
# their backward, and move ReLU/LeakyReLU inputs near 0 to the other slope;
# either path's bf16 gradients differ from the fp32 ones by 7-14% (a CPU run
# at 32²). fp32 (TF32 off): on the CPU, fp32 sums in another order gave 3e-3
# at a step where one LeakyReLU input took the other slope.
STEP_TOL = {"bf16": (2e-2, 2e-1), "fp32": (1e-4, 1e-2)}   # (losses, gradients)
# bf16 against fp32: the kernel path's error at most this factor of the plain
# path's, plus the slack (the two share the convs' bf16 rounding)
BF16_FACTOR, BF16_SLACK = 1.5, 1e-3
SOURCES = {"instance_norm_fwd": "gan_tpu_torch/csrc/instance_norm.cu",
           "instance_norm_bwd": "gan_tpu_torch/csrc/instance_norm.cu",
           "stem_conv": "gan_tpu_torch/csrc/stem_conv.cu"}
REPLACES = {"instance_norm_fwd": "gan_tpu/ops/pallas_kernels.py:89",
            "instance_norm_bwd": "gan_tpu/ops/pallas_kernels.py:128",
            "stem_conv": "benchmarks/pallas_stem_proto.py:46"}
DISC_NORM_SITES = ((64, 128), (32, 256), (31, 512))   # the PatchGAN's at 256²
CYCLEGAN_STEMS_PER_STEP = 10   # 6 generator and 4 discriminator forwards
PIX2PIX_STEMS_PER_STEP = 3   # G(x), D(x, y), D(x, G(x)): one stem each
# (batch, C_in) of every stem the paths run at 256², and what runs it
STEM_SHAPES = {(P2P_BATCH, 1): "Pix2Pix G, train step",
               (P2P_BATCH, 2): "Pix2Pix D on (input, target), train step",
               (BATCH, 1): "predict chunk, both models",
               (TRAIN_BATCH, 1): "CycleGAN G and D, train step",
               (TRAIN_BATCH, 3): "3-channel G and CycleGAN D",
               (TRAIN_BATCH, 6): "3-channel Pix2Pix D"}
# the training shapes, and whether their step needs dx (D's input holds the fake)
STEM_TRAIN_SHAPES = {(P2P_BATCH, 1): False, (P2P_BATCH, 2): True, (TRAIN_BATCH, 1): True}


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def norm_sites(img_size: int, depth: int) -> list[tuple[int, int]]:
    """(H = W, C) of each norm in the generator, in call order."""
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
    calls where it fits, as it does after the op that writes it. Warm-up
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


def bound_ms(nbytes: int, flops: float = 0.0, dtype=torch.bfloat16) -> tuple[float, str]:
    """The least time the card could take: the larger of moving ``nbytes``
    through device memory and doing ``flops`` at the peak for ``dtype``."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _library_norm(x, weight, bias, eps=norm.IN_EPS):
    """One PyTorch call for the instance norm of an NCHW tensor:
    ``F.instance_norm``, or at H·W = 1, which it refuses, ``F.group_norm``
    with one channel a group (the same function)."""
    if x.shape[2] * x.shape[3] == 1:
        return F.group_norm(x, x.shape[1], weight=weight, bias=bias, eps=eps)
    return F.instance_norm(x, weight=weight, bias=bias, eps=eps)


def library_fwd(x, scale, offset, act=None, eps=norm.IN_EPS):
    """K1's function through the library, on the NCHW view of the NHWC
    tensor (channels-last memory). With an epilogue it is two calls, the norm
    and then ``F.leaky_relu`` or ``F.relu``: no one PyTorch call does both."""
    y = _library_norm(x.permute(0, 3, 1, 2), scale.to(x.dtype), offset.to(x.dtype), eps)
    if act == "leaky_relu":
        return F.leaky_relu(y, norm.LEAKY_SLOPE)
    return F.relu(y) if act == "relu" else y


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


L2_NOTE = ("device_ms leaves the inputs in the 50 MB L2 between calls where they fit, so a "
           "share of the byte bound above 100% at a small site means L2, not an error")


def _plan_str(plan) -> str:
    return f"{plan.k}/{plan.channel_tile}/{plan.smem_bytes}"


def print_max_clusters(n: int, hw: int, c: int, backward: bool) -> None:
    """cudaOccupancyMaxActiveClusters of the largest site's plans."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = kernels.norm_plan(n, hw * hw, c, dtype, backward=backward)
        print(f"cudaOccupancyMaxActiveClusters, {'K2' if backward else 'K1'} at {n},{hw},{hw},{c} "
              f"{str(dtype)[6:]}: {kernels.max_active_clusters(plan, n, c, dtype, backward)} "
              f"clusters of {plan.k} ({plan.blocks} blocks in {plan.blocks // plan.k} clusters; "
              f"{plan})")


# other geometries to hold the chosen plan against at the largest site:
# (blocks per cluster, channel tile)
PLAN_SWEEP = ((8, 64), (16, 64), (8, 32), (4, 32), (16, 16))


def plan_sweep(n: int, hw: int, c: int, backward: bool) -> None:
    """The chosen plan of K1 (or K2) at ``n``×``hw``²×``c`` in bf16 against
    the PLAN_SWEEP geometries: each checked against the plain version, with
    its cudaOccupancyMaxActiveClusters and device time."""
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = (torch.randn(n, hw, hw, c, device="cuda", generator=g) * 3.0 + 1.0).to(dtype)
    scale = 1.0 + 0.02 * torch.randn(c, device="cuda", generator=g)
    offset = 0.1 * torch.randn(c, device="cuda", generator=g)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(dtype)
    chosen = kernels.norm_plan(n, hw * hw, c, dtype, backward=backward)
    plans = [chosen]
    for k, ct in PLAN_SWEEP:
        p = kernels.make_plan(n, hw * hw, c, dtype, k, ct, chosen.vec, backward=backward)
        if p not in plans and p.smem_bytes <= kernels.MAX_SMEM:
            plans.append(p)
    if backward:
        want = norm.instance_norm_backward(x, scale, dy)[0]
    else:
        want = norm.instance_norm(x, scale, offset)
    b_ms, _ = bound_ms((3 if backward else 2) * x.numel() * x.element_size())
    atol, rtol = KERNEL_TOL[dtype]
    for p in plans:
        if backward:
            fn = lambda: kernels._launch_bwd(x, scale, dy, norm.IN_EPS, plan=p)[0]
        else:
            fn = lambda: kernels._launch_fwd(x, scale, offset, None, norm.IN_EPS, plan=p)
        torch.testing.assert_close(fn().float(), want.float(), atol=atol, rtol=rtol)
        ms = device_ms(fn)
        print(f"  {'chosen' if p is chosen else 'other ':>6} k {p.k:>2}, tile {p.channel_tile:>2}, "
              f"staged {p.staged}, {p.smem_bytes:>6} B, {p.blocks:>4} blocks, "
              f"{kernels.max_active_clusters(p, n, c, dtype, backward):>3} clusters at once: "
              f"{ms * 1e3:8.2f} us, {b_ms / ms:6.1%} of the bound", flush=True)
        if p is chosen:
            print_timeline(fn, p, backward)


# the timeline's phases: (name, from point, to point), csrc/instance_norm.cu
TIMELINE = {False: (("stage x", 0, 1), ("band sums", 1, 3), ("exchange, merge", 3, 12),
                    ("normalise, store", 12, 6)),
            True: (("stage x (dy)", 0, 1), ("band sums with dy", 1, 3),
                   ("exchange, merge", 3, 12), ("dx, store", 12, 6))}


def print_timeline(fn, plan, backward: bool) -> None:
    """Median µs of each phase of a block, from the kernels' per-block
    timeline of one launch, and when the blocks started (waves)."""
    t = kernels.norm_timeline(fn, plan, "cuda").cpu().double()
    ns_per_cycle = float(((t[:, 13] - t[:, 14]) / (t[:, 6] - t[:, 0])).median())
    phases = {name: float((t[:, b] - t[:, a]).median()) * ns_per_cycle / 1e3
              for name, a, b in TIMELINE[backward]}
    starts = (t[:, 14] - t[:, 14].min()) / 1e3
    span = float((t[:, 13].max() - t[:, 14].min()) / 1e3)
    print("  block phases, median us: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
          + f"; blocks start at {[round(float(q), 2) for q in starts.quantile(torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64))]} us "
          f"(min, median, max), the launch spans {span:.2f} us", flush=True)


def check_kernel(sites) -> dict:
    """Phase 3. Returns per-shape times and the largest error. Rows with
    eps 1e-3 are per-image batch norm (Pix2Pix's predict). plan: blocks per
    cluster / channel tile / shared-memory bytes; share: bound over kernel
    time; k/lib: kernel over library time."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = sorted(set(sites))
    times, worst = {}, 0.0
    print(L2_NOTE)
    print(f"{'N,H,W,C':>18} {'dtype':>9} {'act':>10} {'eps':>6} {'max_abs_err':>12} "
          f"{'tol(atol,rtol)':>16} {'plan':>14} {'kernel_us':>10} {'plain_us':>10} "
          f"{'library_us':>10} {'bound_us':>9} {'share':>7} {'k/lib':>6}")
    for hw, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            plan = kernels.norm_plan(BATCH, hw * hw, c, dtype)
            for act, eps in [(act, norm.IN_EPS) for act in norm.ACTS] + [(None, norm.BN_EPS)]:
                x = (torch.randn(BATCH, hw, hw, c, device="cuda", generator=g) * 3.0 + 1.0).to(dtype)
                scale = 1.0 + 0.02 * torch.randn(c, device="cuda", generator=g)
                offset = 0.1 * torch.randn(c, device="cuda", generator=g)
                got = kernels.instance_norm(x, scale, offset, act=act, eps=eps)
                torch.cuda.synchronize()
                want = norm.instance_norm(x, scale, offset, act=act, eps=eps)
                err = (got.float() - want.float()).abs().max().item()
                atol, rtol = KERNEL_TOL[dtype]
                torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
                worst = max(worst, err)
                k_ms = device_ms(lambda: kernels.instance_norm(x, scale, offset, act=act, eps=eps))
                p_ms = device_ms(lambda: norm.instance_norm(x, scale, offset, act=act, eps=eps))
                lib_ms = device_ms(lambda: library_fwd(x, scale, offset, act, eps))
                b_ms, _ = bound_ms(2 * x.numel() * x.element_size())
                times[(hw, c, dtype, act, eps)] = (k_ms, p_ms, lib_ms, b_ms)
                print(f"{f'{BATCH},{hw},{hw},{c}':>18} {str(dtype)[6:]:>9} {str(act):>10} "
                      f"{eps:>6g} {err:>12.3e} {f'{atol:g},{rtol:g}':>16} {_plan_str(plan):>14} "
                      f"{k_ms * 1e3:>10.2f} {p_ms * 1e3:>10.2f} {lib_ms * 1e3:>10.2f} "
                      f"{b_ms * 1e3:>9.2f} {b_ms / k_ms:>7.1%} {k_ms / lib_ms:>6.2f}", flush=True)
    hw, c = max(shapes, key=lambda s: s[0] * s[0] * s[1])
    print_max_clusters(BATCH, hw, c, backward=False)
    print(f"plans at {BATCH},{hw},{hw},{c} bf16, K1:")
    plan_sweep(BATCH, hw, c, backward=False)
    return {"times": times, "max_abs_err": worst}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def check_stem() -> dict:
    """Phase 4: S against its plain version at every stem shape of the
    paths, forward in both dtypes and backward at the training shapes.
    Returns per-shape (kernel, plain, library, bound) times, bound kinds and
    the largest forward error."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    times, bound_by, worst = {}, {}, 0.0
    print(f"{'N,H,W,C_in':>16} {'dtype':>9} {'max_abs_err':>12} {'tol(atol,rtol)':>20} "
          f"{'kernel_us':>10} {'plain_us':>10} {'library_us':>10} {'bound_us':>9} "
          f"{'dx_rel':>9} {'dw_rel':>9}  path")
    for (n, c_in), use in STEM_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.rand(n, IMG_SIZE, IMG_SIZE, c_in, device="cuda", generator=g) * 2 - 1).to(dtype)
            w = (0.02 * torch.randn(64, c_in, 4, 4, device="cuda", generator=g)).to(
                memory_format=torch.channels_last)   # as the models keep it
            got = kernels.stem_conv(x, w, compute_dtype=dtype)
            torch.cuda.synchronize()
            want = conv.stem_conv(x, w, compute_dtype=dtype)
            atol, rtol = STEM_TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            grads = ["", ""]
            if (n, c_in) in STEM_TRAIN_SHAPES:
                needs_dx = STEM_TRAIN_SHAPES[n, c_in]
                dy = torch.randn(got.shape, device="cuda", generator=g).to(dtype)
                res = []
                for fn in (kernels.stem_conv, conv.stem_conv):
                    xl = x.detach().requires_grad_(needs_dx)
                    wl = w.detach().requires_grad_()
                    leaves = (xl, wl) if needs_dx else (wl,)
                    res.append(torch.autograd.grad(fn(xl, wl, compute_dtype=dtype), leaves, dy))
                errs = [_rel(a, b) for a, b in zip(*res)]
                if max(errs) > STEM_BWD_TOL[dtype]:
                    raise AssertionError(f"stem backward {n},{c_in} {dtype}: relative errors {errs}")
                grads = ([f"{errs[0]:.2e}", f"{errs[1]:.2e}"] if needs_dx
                         else ["-", f"{errs[0]:.2e}"])
            k_ms = device_ms(lambda: kernels.stem_conv(x, w, compute_dtype=dtype))
            p_ms = device_ms(lambda: conv.stem_conv(x, w, compute_dtype=dtype))
            xl, wl = x.permute(0, 3, 1, 2), w.to(dtype)
            lib_ms = device_ms(lambda: F.leaky_relu(F.conv2d(xl, wl, stride=2, padding=1),
                                                    norm.LEAKY_SLOPE))
            nbytes = (x.numel() + w.numel() + got.numel()) * x.element_size()
            b_ms, by = bound_ms(nbytes, 2.0 * got.numel() * 16 * c_in, dtype)
            times[(n, c_in, dtype)] = (k_ms, p_ms, lib_ms, b_ms)
            bound_by[(n, c_in, dtype)] = by
            print(f"{f'{n},{IMG_SIZE},{IMG_SIZE},{c_in}':>16} {str(dtype)[6:]:>9} {err:>12.3e} "
                  f"{f'{atol:g},{rtol:g}':>20} {k_ms * 1e3:>10.2f} {p_ms * 1e3:>10.2f} "
                  f"{lib_ms * 1e3:>10.2f} {b_ms * 1e3:>9.2f} {grads[0]:>9} {grads[1]:>9}  "
                  f"{use} (bound by {by})", flush=True)
    return {"times": times, "bound_by": bound_by, "max_abs_err": worst}


def check_backward(shapes) -> dict:
    """Phase 6: K2 (and K1) against the plain versions at batch 8. Returns
    per-shape K2 times and the largest error. Columns as in phase 3."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    times, worst = {}, 0.0
    print(L2_NOTE)
    print(f"{'N,H,W,C':>18} {'dtype':>9} {'dx_err':>10} {'dscale_err':>10} {'doffset_err':>11}"
          f" {'tol(dx;sums)':>20} {'k1_err':>9} {'plan':>14} {'kernel_us':>10} {'plain_us':>10}"
          f" {'library_us':>10} {'bound_us':>9} {'share':>7} {'k/lib':>6}")
    for hw, c in shapes:
        shape = (TRAIN_BATCH, hw, hw, c)
        for dtype in (torch.float32, torch.bfloat16):
            plan = kernels.norm_plan(TRAIN_BATCH, hw * hw, c, dtype, backward=True)
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
            b_ms, _ = bound_ms(3 * x.numel() * x.element_size())
            times[(hw, c, dtype)] = (k_ms, p_ms, lib_ms, b_ms)
            print(f"{','.join(map(str, shape)):>18} {str(dtype)[6:]:>9} {errs[0]:>10.3e} "
                  f"{errs[1]:>10.3e} {errs[2]:>11.3e} {f'{atol:g},{rtol:g};{s_tol:.3g}':>20} "
                  f"{k1_err:>9.2e} {_plan_str(plan):>14} {k_ms * 1e3:>10.2f} {p_ms * 1e3:>10.2f} "
                  f"{lib_ms * 1e3:>10.2f} {b_ms * 1e3:>9.2f} {b_ms / k_ms:>7.1%} "
                  f"{k_ms / lib_ms:>6.2f}", flush=True)
    hw, c = max(shapes, key=lambda s: s[0] * s[0] * s[1])
    print_max_clusters(TRAIN_BATCH, hw, c, backward=True)
    print(f"plans at {TRAIN_BATCH},{hw},{hw},{c} bf16, K2:")
    plan_sweep(TRAIN_BATCH, hw, c, backward=True)
    return {"times": times, "max_abs_err": worst}


def offsets_from_seed(trainer) -> None:
    """Seeded non-zero norm offsets (instance norm) and betas (batch norm):
    at init they are 0, and a norm over one value per channel (H·W = 1, or
    per-image batch norm at the 1×1 bottleneck) returns exactly that, so the
    bottleneck would carry nothing."""
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for net in trainer.nets.values():
            for pname, p in net.named_parameters():
                if pname.endswith(("offset", "beta")):
                    p.copy_(0.1 * torch.randn(p.shape, generator=g))


def compare(name: str, got: np.ndarray, want: np.ndarray, tol) -> None:
    d = np.abs(got - want)
    mx, mean = float(d.max()), float(d.mean())
    print(f"{name}: max_abs_err {mx:.3e} (tol {tol[0]:g}), mean_abs_err {mean:.3e} (tol {tol[1]:g})")
    if not (mx <= tol[0] and mean <= tol[1]):
        raise AssertionError(f"{name}: kernel path disagrees with the plain path")


def plain_path(label: str):
    """The blocks' kernels (S and K1) as their plain versions ('plain'), or
    as they are."""
    if label != "plain":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(blocks, "instance_norm", norm.instance_norm))
    stack.enter_context(mock.patch.object(blocks, "stem_conv", conv.stem_conv))
    return stack


# kernel groups of the profile, by substring of the kernel name; first match wins
_GROUPS = (("stem conv (CUDA kernel S)", ("stem_conv_kernel",)),
           ("instance norm forward (CUDA kernel K1)", ("instance_norm_fwd_kernel",)),
           ("instance norm backward (CUDA kernel K2)", ("instance_norm_bwd_kernel",)),
           ("batch norm (PyTorch's kernels)", ("batch_norm", "bn_fw", "bn_bw", "welford")),
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


def timed_paths(fn, rounds: int, reps: int) -> dict:
    """Median eager times of ``fn`` per path, kernel and plain in turns."""
    runs = {"kernel": [], "plain": []}
    for order in (("kernel", "plain"), ("plain", "kernel")) * rounds:
        for label in order:
            with plain_path(label):
                runs[label].append(median_ms(fn, reps=reps))
    return runs


def profile_paths(fn, calls: int, runs: dict, what: str) -> None:
    for label in ("kernel", "plain"):
        print(f"{label} path, device time per {what}:")
        with plain_path(label):
            busy_us = profile_device(fn, calls)
        eager_ms = float(np.median(runs[label]))
        print(f"  {busy_us:10.2f} us  sum of kernel time; eager {what} median {eager_ms:.3f} ms, "
              f"so the card is idle {1 - busy_us / 1e3 / eager_ms:.1%} of it")


def _restore_checked(trainer, weights: str, seeded) -> None:
    """Restore as ``--predict`` does, and hold the weights to the saved ones."""
    trainer.load_state(CheckpointManager(latest_checkpoint_dir(weights)).restore(
        map_location="cpu"))
    for a, b in zip(seeded.sampler.state_dict().values(), trainer.sampler.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError("checkpoint round trip changed the weights")


def check_predict(trainer, trainer32, u8, norm_type) -> tuple[dict, np.ndarray]:
    """``generate_batched`` on the kernel path (with its launches counted,
    the norm sites' shapes recorded), against the plain path in bf16 and in
    fp32, then the predict rate. Returns the launches and the output."""
    seen = set()
    for m in trainer.sampler.modules():
        if isinstance(m, norm_type):
            m.register_forward_hook(lambda mod, inp, o: seen.add(tuple(inp[0].shape[1:])))
    passes = -(-u8.shape[0] // BATCH)
    kernels.reset_launches()
    pred = trainer.generate_batched(u8, chunk=BATCH)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {"instance_norm_fwd": 14 * passes, "instance_norm_bwd": 0, "stem_conv": passes}
    print(f"launches on the predict path: {launches} over {passes} generator passes, "
          f"expected {want}")
    if launches != want:
        raise AssertionError("launch counts differ from the generator's structure")
    want_sites = {(hw, hw, c) for hw, c in norm_sites(IMG_SIZE, generator_depth(IMG_SIZE))}
    if seen != want_sites:
        raise AssertionError(f"norm shapes {sorted(seen)} != compared {sorted(want_sites)}")
    if pred.shape != (u8.shape[0], IMG_SIZE, IMG_SIZE, 1) or pred.dtype != np.float32:
        raise AssertionError(f"output {pred.shape} {pred.dtype}")
    if not (np.isfinite(pred).all() and np.abs(pred).max() <= 1.0):
        raise AssertionError("output not finite or outside [-1, 1]")
    print(f"output {pred.shape} in [{pred.min():.4f}, {pred.max():.4f}], std {pred.std():.4f}")
    with plain_path("plain"):
        plain = trainer.generate_batched(u8, chunk=BATCH)
    compare("bf16 slice, kernel vs plain path", pred, plain, SLICE_TOL["bf16"])
    # the same weights in fp32 (TF32 off): kernel and plain paths agree closely
    trainer32.load_state(trainer.state())
    k32 = trainer32.generate_batched(u8[:4], chunk=4)
    with plain_path("plain"):
        p32 = trainer32.generate_batched(u8[:4], chunk=4)
    compare("fp32 slice, kernel vs plain path", k32, p32, SLICE_TOL["fp32"])
    # end-to-end predict rate: host uint8 in, host fp32 out (7 runs, median)
    runs = []
    for _ in range(7):
        t0 = time.perf_counter()
        trainer.generate_batched(u8, chunk=BATCH)
        runs.append(time.perf_counter() - t0)
    e2e = float(np.median(runs))
    print(f"predict {u8.shape[0]} images at {IMG_SIZE}² bf16: {e2e * 1e3:.2f} ms "
          f"(runs {[round(r * 1e3, 2) for r in runs]}), {u8.shape[0] / e2e:.2f} images/s, "
          f"{e2e / passes * 1e3:.2f} ms per batch of {BATCH}")
    return launches, pred


def run_slice(tmp: str) -> dict:
    """Phase 5. Returns the kernel launch counts of the main-path run."""
    images, out, weights = (os.path.join(tmp, d) for d in ("x", "out", "run"))
    argv = ["--input-images", images, "--output", out, "--predict", "--weights", weights,
            "--img-size", str(IMG_SIZE), "--channels", "1", "--dtype", "bf16"]
    cfg = parse_cyclegan(argv)
    seeded = CycleGANTrainer(cfg)
    offsets_from_seed(seeded)
    n_params = sum(p.numel() for p in seeded.gen_g.parameters())
    print(f"generator: depth {generator_depth(cfg.img_size)}, {n_params / 1e6:.2f} M parameters, "
          f"device {seeded.device}")
    CheckpointManager(os.path.join(weights, "training_checkpoints"), max_to_keep=3).save(
        1, seeded.state())
    trainer = CycleGANTrainer(cfg)       # as --predict does: build, then restore
    _restore_checked(trainer, weights, seeded)
    del seeded

    u8 = np.random.default_rng(SEED).integers(0, 256, (N_IMAGES, IMG_SIZE, IMG_SIZE, 1),
                                              dtype=np.uint8)
    launches, _ = check_predict(trainer, CycleGANTrainer(parse_cyclegan(argv[:-1] + ["fp32"])),
                                u8, blocks.InstanceNorm)
    # one generator pass on a resident batch of 16, kernel and plain in turns
    x = normalize_batch(torch.from_numpy(u8[:BATCH]).to("cuda"), torch.bfloat16)
    gen = torch.Generator(device="cuda")

    def fwd():
        with torch.no_grad():
            trainer.gen_g(x, generator=gen.manual_seed(0), compute_dtype=torch.bfloat16)

    fwd_runs = timed_paths(fwd, rounds=4, reps=10)
    for label, runs_ms in fwd_runs.items():
        print(f"generator forward, batch {BATCH} resident on the card, {label} path: "
              f"median {np.median(runs_ms):.3f} ms (rounds {[round(r, 3) for r in runs_ms]})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase(f"5b. profile: CycleGAN generator forward, batch {BATCH} resident on the card")
    profile_paths(fwd, 5, fwd_runs, "forward")
    return launches


def check_step_paths(bf16, fp32, x, y, draws) -> None:
    """One step's losses and per-network gradients from the same state,
    batch and dropout draws (``draws(trainer)``), through the kernels and on
    the plain path, in fp32 (TF32 off) and bf16; nothing is updated. fp32:
    kernel path against plain path. bf16: each path against the fp32 plain
    path, and the kernel path no further from it than the plain path is,
    within a factor (bf16 rounding in the convs is common to both)."""
    runs = {}
    for label, trainer, xs, ys in (("bf16", bf16, x, y), ("fp32", fp32, x.float(), y.float())):
        for path in ("kernel", "plain"):
            with plain_path(path):
                grads, losses = trainer.gradients(xs, ys, draws(trainer))
            runs[label, path] = ({k: torch.cat([g.flatten().float() for g in v])
                                  for k, v in grads.items()}, losses)
    ref_losses = runs["fp32", "plain"][1]
    names = list(bf16.nets)

    def errs(key, against=("fp32", "plain")):
        grads, losses = runs[key]
        want_grads, want_losses = runs[against]
        loss_err = ((losses - want_losses).abs() / want_losses.abs()).max().item()
        return loss_err, {k: _rel(grads[k], want_grads[k]) for k in names}

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
            and all(gk[k] <= BF16_FACTOR * gp[k] + BF16_SLACK for k in names))
    if not (ok32 and ok16):
        raise AssertionError("train step: kernel path disagrees with the plain path")


def check_fit(trainer, make_trainer, fit, want: dict, steps: int) -> tuple[dict, float]:
    """``fit`` (one epoch) with its launches counted against ``want``; finite
    losses, every network changed, and a checkpoint round trip of every
    network and Adam. Returns the launches and the peak device memory."""
    before = {k: [p.detach().clone() for p in v] for k, v in trainer.params.items()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    train_cost, val_cost, mgr = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"fit: {fit_s:.2f} s with the first step's set-up; launches {launches}, expected "
          f"{want}; peak device memory {peak:.2f} GiB")
    if launches != want:
        raise AssertionError("launch counts differ from the step's derivation")
    for k in train_cost:
        print(f"  {k}: train {train_cost[k][0]:.4f}, val {val_cost[k][0]:.4f}")
    if not all(math.isfinite(v[0]) for d in (train_cost, val_cost) for v in d.values()):
        raise AssertionError("a loss is not finite")
    unchanged = [k for k in trainer.nets
                 if all(torch.equal(a, b) for a, b in zip(before[k], trainer.params[k]))]
    if unchanged:
        raise AssertionError(f"fit left {unchanged} unchanged")
    del before

    restored = make_trainer()
    # on the CPU: the Adams keep their step counts there, and move the moments to the card
    restored.load_state(mgr.restore(map_location="cpu"))
    for name in trainer.nets:
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
    adam_steps = int(sa["state"][0]["step"])
    print(f"checkpoint {mgr.all_epochs()}: {len(trainer.nets)} networks and Adams "
          f"(step {adam_steps}) restored equal")
    if adam_steps != steps:
        raise AssertionError(f"Adam took {adam_steps} steps, expected {steps}")
    return launches, peak


def step_numbers(step, batch: int, peak: float, what: str) -> None:
    """The median step time per path in alternating rounds, images/s, and a
    profile of two steps per path."""
    runs = timed_paths(step, rounds=3, reps=5)
    for label, runs_ms in runs.items():
        med = float(np.median(runs_ms))
        print(f"train step, {label} path: median {med:.3f} ms "
              f"(rounds {[round(r, 3) for r in runs_ms]}), {batch / med * 1e3:.2f} {what}/s")
    print(f"peak device memory of fit {peak:.2f} GiB")
    profile_paths(step, 2, runs, "train step")


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
    mgr = CheckpointManager(os.path.join(tmp, "training_checkpoints"), max_to_keep=3)

    bwd_calls = [0]
    real_backward = kernels.InstanceNormFunction.backward

    def counted_backward(ctx, dy):
        bwd_calls[0] += 1
        return real_backward(ctx, dy)

    train_steps = -(-min(N_TRAIN_X, N_TRAIN_Y) // TRAIN_BATCH)
    val_steps = -(-N_VAL // TRAIN_BATCH)
    k1, k2 = train_step_launches(len(norm_sites(IMG_SIZE, generator_depth(IMG_SIZE))),
                                 len(DISC_NORM_SITES))
    want = {"instance_norm_fwd": (train_steps + val_steps) * k1,
            "instance_norm_bwd": train_steps * k2,
            "stem_conv": (train_steps + val_steps) * CYCLEGAN_STEMS_PER_STEP}
    print(f"1 epoch: {train_steps} train steps (the last a zip tail of "
          f"{N_TRAIN_X - (train_steps - 1) * TRAIN_BATCH} X and {TRAIN_BATCH} Y rows) and "
          f"{val_steps} val steps; per train step {k1} K1, {k2} K2 and "
          f"{CYCLEGAN_STEMS_PER_STEP} S, per val step {k1} K1 and {CYCLEGAN_STEMS_PER_STEP} S")

    def fit():
        with mock.patch.object(kernels.InstanceNormFunction, "backward",
                               staticmethod(counted_backward)):
            return (*trainer.fit(train_x, train_y, val_x, val_y, test, tmp,
                                 checkpoint_manager=mgr), mgr)

    launches, peak = check_fit(trainer, lambda: CycleGANTrainer(cfg), fit, want, train_steps)
    print(f"InstanceNormFunction.backward calls {bwd_calls[0]}")
    if bwd_calls[0] != want["instance_norm_bwd"]:
        raise AssertionError("K2 calls differ from the norm backwards")

    # one step from the fitted state, kernel path vs plain path
    u8x = torch.from_numpy(train_x[:TRAIN_BATCH]).to("cuda")
    u8y = torch.from_numpy(train_y[:TRAIN_BATCH]).to("cuda")
    gx, gy = (torch.Generator(device="cuda").manual_seed(SEED + i) for i in (4, 5))
    x = single_jitter_batch(u8x, gx, img_size=IMG_SIZE, dtype=torch.bfloat16)
    y = single_jitter_batch(u8y, gy, img_size=IMG_SIZE, dtype=torch.bfloat16)
    trainer32 = CycleGANTrainer(parse_cyclegan(argv[:-1] + ["fp32"]))
    trainer32.load_state(trainer.state())
    check_step_paths(trainer, trainer32, x, y,
                     lambda t: [t._draws(SEED, 0, 0, 0, app) for app in range(6)])
    del trainer32

    phase(f"8. CycleGAN training numbers: train step at {IMG_SIZE}², bf16, batch {TRAIN_BATCH}, "
          "uint8 batch resident on the card")
    # what fit runs per step: draws, jitter, gradients, four Adam updates
    step_numbers(lambda: trainer._step(u8x, u8y, 0, 0, 0), TRAIN_BATCH, peak, "image-pairs")
    return launches


def run_pix2pix_predict(tmp: str) -> dict:
    """Phase 9. Returns the kernel launch counts of the main-path run."""
    data, out, weights = (os.path.join(tmp, d) for d in ("data", "out", "run"))
    argv = ["--data", data, "--output", out, "--predict", "--weights", weights,
            "--img-size", str(IMG_SIZE), "--channels", "1", "--dtype", "bf16"]
    cfg = parse_pix2pix(argv)
    seeded = Pix2PixTrainer(cfg)
    offsets_from_seed(seeded)
    print(f"generator: depth {generator_depth(cfg.img_size)}, batch norm, "
          f"{sum(p.numel() for p in seeded.gen.parameters()) / 1e6:.2f} M parameters; "
          f"discriminator {sum(p.numel() for p in seeded.disc.parameters()) / 1e6:.2f} M")
    CheckpointManager(os.path.join(weights, "training_checkpoints"), max_to_keep=1).save(
        1, seeded.state())
    trainer = Pix2PixTrainer(cfg)
    _restore_checked(trainer, weights, seeded)
    del seeded
    u8 = np.random.default_rng(SEED + 7).integers(0, 256, (N_IMAGES, IMG_SIZE, IMG_SIZE, 1),
                                                  dtype=np.uint8)
    launches, _ = check_predict(trainer, Pix2PixTrainer(parse_pix2pix(argv[:-1] + ["fp32"])),
                                u8, blocks.BatchNorm)
    return launches


def run_pix2pix_training(tmp: str) -> dict:
    """Phases 10 and 11. Returns the kernel launch counts of the main-path run."""
    argv = ["--data", tmp, "--output", tmp, "--train", "--epochs", "1",
            "--img-size", str(IMG_SIZE), "--batch-size", str(P2P_BATCH), "--dtype", "bf16"]
    cfg = parse_pix2pix(argv)
    trainer = Pix2PixTrainer(cfg)
    offsets_from_seed(trainer)
    rng = np.random.default_rng(SEED + 8)
    pad = IMG_SIZE + 30
    train = rng.integers(0, 256, (N_P2P_TRAIN, 2, pad, pad, 1), dtype=np.uint8)
    val = rng.integers(0, 256, (N_P2P_VAL, 2, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8)
    test = rng.integers(0, 256, (1, 2, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8)
    mgr = CheckpointManager(os.path.join(tmp, "training_checkpoints"), max_to_keep=1)
    train_steps, val_steps = -(-N_P2P_TRAIN // P2P_BATCH), -(-N_P2P_VAL // P2P_BATCH)
    want = {"instance_norm_fwd": 0, "instance_norm_bwd": 0,
            "stem_conv": PIX2PIX_STEMS_PER_STEP * (train_steps + val_steps)}
    print(f"1 epoch: {train_steps} train steps (the last of {N_P2P_TRAIN % P2P_BATCH} rows) and "
          f"{val_steps} val steps (the last of {N_P2P_VAL % P2P_BATCH} rows), "
          f"{PIX2PIX_STEMS_PER_STEP} S per step, no K1 or K2 (batch statistics)")

    def fit():
        return (*trainer.fit(train, val, test, tmp, checkpoint_manager=mgr), mgr)

    launches, peak = check_fit(trainer, lambda: Pix2PixTrainer(cfg), fit, want, train_steps)

    u8 = torch.from_numpy(train[:P2P_BATCH]).to("cuda")
    x, y = paired_jitter_batch(u8, torch.Generator(device="cuda").manual_seed(SEED + 4),
                               img_size=IMG_SIZE, dtype=torch.bfloat16)
    trainer32 = Pix2PixTrainer(parse_pix2pix(argv[:-1] + ["fp32"]))
    trainer32.load_state(trainer.state())
    check_step_paths(trainer, trainer32, x, y, lambda t: t._draws(SEED, 0, 0, 0, 0))
    del trainer32

    phase(f"11. Pix2Pix training numbers: train step at {IMG_SIZE}², bf16, batch {P2P_BATCH}, "
          "uint8 batch resident on the card")
    # what fit runs per step: draws, paired jitter, gradients, two Adam updates
    step_numbers(lambda: trainer._step(u8, 0, 0, 0), P2P_BATCH, peak, "image-pairs")
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

    phase("3. instance-norm forward kernel (K1) vs plain, generator shapes, batch 16")
    sites = norm_sites(IMG_SIZE, generator_depth(IMG_SIZE))
    if len(sites) != 14:
        raise AssertionError(f"expected 14 norm sites, got {sites}")
    k = check_kernel(sites)
    k1_pass = [sum(k["times"][(hw, c, torch.bfloat16, None, norm.IN_EPS)][i] for hw, c in sites)
               for i in range(4)]
    print(f"14 sites of one bf16 generator pass at batch {BATCH}: kernel {k1_pass[0] * 1e3:.2f} us, "
          f"plain {k1_pass[1] * 1e3:.2f} us, F.instance_norm {k1_pass[2] * 1e3:.2f} us, "
          f"bound {k1_pass[3] * 1e3:.2f} us; share of bound {k1_pass[3] / k1_pass[0]:.1%}, "
          f"kernel/library {k1_pass[0] / k1_pass[2]:.2f}")
    for act in ("leaky_relu", "relu"):
        t = k["times"][(128, 64, torch.bfloat16, act, norm.IN_EPS)]
        print(f"K3 ({act} epilogue) at 128²×64, bf16, batch {BATCH}: kernel {t[0] * 1e3:.2f} us, "
              f"plain {t[1] * 1e3:.2f} us, library (norm, then activation: two calls) "
              f"{t[2] * 1e3:.2f} us, bound {t[3] * 1e3:.2f} us; kernel/library {t[0] / t[2]:.2f}")

    phase(f"4. stem kernel (S) vs plain, every stem shape at {IMG_SIZE}²")
    s = check_stem()
    p2p_stems = [(P2P_BATCH, 1), (P2P_BATCH, 2), (P2P_BATCH, 2)]
    s_step = [sum(s["times"][(n, c, torch.bfloat16)][i] for n, c in p2p_stems) for i in range(4)]
    # what bounds the sum: the kind that bounds most of it
    by_kind = {}
    for n, c in p2p_stems:
        kind_nc = s["bound_by"][(n, c, torch.bfloat16)]
        by_kind[kind_nc] = by_kind.get(kind_nc, 0.0) + s["times"][(n, c, torch.bfloat16)][3]
    s_by = max(by_kind, key=by_kind.get)
    print(f"the 3 stems of one bf16 Pix2Pix train step at batch {P2P_BATCH}: kernel "
          f"{s_step[0] * 1e3:.2f} us, plain {s_step[1] * 1e3:.2f} us, F.conv2d + F.leaky_relu "
          f"{s_step[2] * 1e3:.2f} us, bound {s_step[3] * 1e3:.2f} us (by {s_by})")

    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    phase("5. CycleGAN predict slice")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_slice(tmp))

    phase(f"6. instance-norm backward kernel (K2) vs plain, training shapes, batch {TRAIN_BATCH}")
    step_sites = sites + list(DISC_NORM_SITES)
    b = check_backward(sorted(set(step_sites)))
    k2_pass = [sum(b["times"][(hw, c, torch.bfloat16)][i] for hw, c in step_sites)
               for i in range(4)]
    print(f"{len(step_sites)} sites of one bf16 generator and one discriminator backward at batch "
          f"{TRAIN_BATCH}: kernel {k2_pass[0] * 1e3:.2f} us, plain {k2_pass[1] * 1e3:.2f} us, "
          f"F.instance_norm backward {k2_pass[2] * 1e3:.2f} us, bound {k2_pass[3] * 1e3:.2f} us; "
          f"share of bound {k2_pass[3] / k2_pass[0]:.1%}, kernel/library "
          f"{k2_pass[0] / k2_pass[2]:.2f}")

    phase(f"7. CycleGAN training slice: fit at {IMG_SIZE}², bf16, batch {TRAIN_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_training(tmp))

    phase(f"9. Pix2Pix predict slice: {IMG_SIZE}², depth 8, bf16, per-image batch norm")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_pix2pix_predict(tmp))

    phase(f"10. Pix2Pix training slice: fit at {IMG_SIZE}², bf16, batch {P2P_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_pix2pix_training(tmp))

    print(f"\nlaunches on the four main paths: {launches}")
    if not all(launches[name] > 0 for name in SOURCES):
        raise AssertionError("a kernel of the paths was never launched")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
         "bound_ms": t[3], "bound_by": by, "library_ms": t[2]}
        for name, err, t, by in (("instance_norm_fwd", k["max_abs_err"], k1_pass, "bytes"),
                                 ("instance_norm_bwd", b["max_abs_err"], k2_pass, "bytes"),
                                 ("stem_conv", s["max_abs_err"], s_step, s_by))]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
