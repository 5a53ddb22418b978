#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name; TF32
   off for the fp32 comparisons;
2. build the CUDA kernels from ``gan_tpu_torch/csrc`` with nvcc (sm_90a),
   and the native PNG decoder (``gan_tpu_torch/data/native/decoder.cpp``)
   with g++ over zlib;
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
   paths run, in fp32 (CUDA cores) and bf16 (tensor cores), with each
   launch's plan, the device time of both, of the library pair ``F.conv2d``
   + ``F.leaky_relu`` and the bound, the share of the bound and the
   kernel/library ratio; its backward (dx and dw through cuDNN) against
   autograd of the plain version at the training shapes; first the count of
   HMMA instructions in each stem kernel's SASS (``cuobjdump``), which must
   not be 0 for the bf16 route. The phase runs alone as
   ``python3 -c "import chip_smoke as c; c.tf32_off(); c.build.build();
   c.check_stem()"``;
5. the CycleGAN predict slice: the port's CycleGAN trainer at 256², depth 8,
   bf16, from seeded random weights, saved and restored through its
   checkpoint manager as ``--predict`` does, runs ``generate_batched`` on 32
   seeded uint8 images; K1 must launch 14 times and S once per generator
   pass, and the output must agree with the same model on the plain path
   (``plain_path``: S and K1 swapped for their plain versions); then
   torch.profiler over 5 generator forwards, kernel and plain path;
6. the backward kernel (K2), and K1, against their plain versions at every
   instance-norm shape of a CycleGAN training step at batch 8, with the
   same columns, plan sweep and timeline as phase 3, and in bf16 at the
   batched form's wider passes (the generator's sites at 16 and 24 rows,
   the discriminator's at 16);
7. the CycleGAN training slice: ``CycleGANTrainer.fit`` for one epoch at
   256², depth 8, bf16, batch 8 on seeded uint8 caches (84 X and 88 Y
   images of 286², 16 + 16 val), in the form the card's crossover selects
   there (``batched_pass_max``: the unbatched form, 6 U-Net and 4 PatchGAN
   passes a step): the full steps
   as CUDA-graph replays (each runner's first step eager, as the capture's
   warm-up), the zip tail eager; K1, K2 and S launches counted on the card
   (by the kernels' own counters) against the counts derived from the
   step's structure (``cyclegan_launches``), the wrappers' counts against
   the steps the host ran or captured, Adam's step count against the steps
   trained, a checkpoint round trip of all four networks and Adams, and one
   step's losses and gradients through the kernels against the same step
   on the plain path, then gan_tpu's batched form's step against the
   unbatched form's with the same masks cut per application
   (``check_forms``), in bf16 and fp32; the peak
   memory of ``fit`` above what was allocated before its trainer was built
   (``reset_memory``);
8. the CycleGAN training numbers: the median eager step time, kernel and
   plain path in alternating rounds, image-pairs/s, peak device memory, and
   a torch.profiler breakdown of two steps with the card's idle share; the
   convs that launch cuDNN's ``dgrad2d_grouped_direct_kernel`` in one eager
   step, by op and input shapes (``trace_dgrad``);
   8b. the graph step: two steps of the epoch runner (the second a replay)
   against two eager steps from the same state and draws, then the graph
   path's step time (an epoch of replays, in turns with the eager step),
   image-pairs/s, device time, idle share and kernels per step beside the
   eager paths', and the capture's seconds;
   8c. the graph step in both forms (``form_sweep``), a fresh seeded
   trainer each, timed in turns at every batch of ``FORM_BATCHES`` (1 to
   32), each form forced, with the launches of its first epoch counted on
   the card against its derivation; at batch 8 also each form's device
   time by kernel group and idle share; then the batches where the batched
   form won, beside the form ``fit`` runs (``batched_pass_max``);
   8d. ``fit`` for one epoch at batch 4 (the reference's), which runs the
   batched form at 256², with phase 7's gates of ``fit`` (``check_fit``:
   launches on the card against the batched derivation, val steps
   included);
9. the Pix2Pix predict slice: ``Pix2PixTrainer`` at 256², depth 8, bf16,
   seeded weights with non-zero batch-norm betas, restored through the
   checkpoint manager, ``generate_batched`` on 32 seeded uint8 images with
   per-image batch norm: S once and K1 14 times per chunk, the output
   against the plain path;
10. the Pix2Pix training slice: ``Pix2PixTrainer.fit`` for one epoch at
    256², bf16, batch 32 (the README's Pix2Pix quick start) on seeded caches
    of 261 train pairs at 286² (8 full steps as graph replays and a 5-row
    remainder) and 40 val pairs (a full step and an 8-row remainder): 3 S
    launches per step on the card and no K1 or K2, the counts as in phase 7,
    finite losses, both networks changed, a checkpoint round trip, and one
    step against the plain path;
11. the Pix2Pix training numbers, as in phase 8, and 11b the graph step as
    in 8b; then, not a gate, an epoch of 8 graph steps at bench.py's
    per-chip batch of 128 with its image-pairs/s and peak memory;
12. the quality slice: seeded random InceptionV3 weights written as an
    ``.npz`` in gan_tpu's ``save_params`` layout and loaded through
    ``models/inception.load_params``; the pool3 features of 8 seeded 299²
    images on the card (TF32 off) against the same module's on the CPU (and
    the gap with TF32 on, not a gate); phase 9's seeded Pix2Pix generator
    (bf16) predicts 64 seeded images, with S once and K1 14 times per chunk
    of 16 on the card, and writes them and 64 seeded targets as PNGs in a
    temporary directory; ``gan_tpu_torch.tools.eval_quality.main`` scores
    them on the card with ``--fid-weights`` (every value finite); then the
    extractor's images/s at batch 64 and 256 (TF32 off, and on for
    information), its peak device memory and the host's ``sqrtm`` seconds;
13. the host-data slice, at 256², depth 8, bf16, from phase 9's and phase
    5's seeded weights, on PNGs of seeded uniform noise written into a
    temporary directory (noise does not compress, the worst case for PNG
    decode): 261 Pix2Pix pairs of 512x256 and 84 X and 88 Y CycleGAN images
    of 256² (phase 10's and phase 7's counts), and as many again at the
    size of the reference corpus's files (``REF_PAIR``: pairs of 1280x512,
    ``REF_SINGLE``: singles of 640x512), decoded by the native PNG decoder
    (``gan_tpu_torch/data/native``, built in phase 2), the default. 13a,
    for pairs and for single images at both sizes: the gate, the native
    rows of every file equal to the PIL twin's bit for bit (train and val
    forms); then native files/s at 1 thread, all cores less one and all
    cores, the PIL twin's at 1 worker and at the FileCache's 16,
    single-threaded ms per file (over the first 64 files) of PIL's decode
    alone, of the numpy split and resizes alone, of the native decode with
    its resizes and of zlib's inflate alone, and ms to a FileCache epoch's
    first batch, beside
    ``os.cpu_count()``; 13b: one
    Pix2Pix ``fit`` epoch at batch 32 from FileCaches (``--host-cache
    off``'s path; val: the first 40 pairs) against the resident epochs from
    the same state: losses, parameters, buffers and Adam's state bit for
    bit, S launches counted on the card against 3 per step and the runner's
    steps against the derivation; then train epochs resident, streamed from
    host memory (``--device-cache off``'s path), from the files and from the
    reference-size files, the first two streamed paths also without their
    prefetch thread, in ``STREAM_ROUNDS`` rounds of turns, and in the first
    round from the files with the decoder at all cores less one and from
    both sizes of files on the PIL twin: pairs/s with every
    reading, device time per step and idle share; 13c: the same for
    CycleGAN at batch 8 from two FileCaches (K1, K2 and S launches); 13d:
    ``predict`` of both models over 64 PNGs from a FileCache against
    ``predict`` over the decoded array: outputs and raw PNG bytes equal, S
    and K1 launches per generator pass, images/s with the raw PNGs written;
    then the count of JPEG files the phase sent to PIL, which must be 0. The
    card's machine has no matplotlib, so 13d draws no grids
    (``save_image_grid`` is stubbed);
14. the 512² slice (the reference's published Pix2Pix run: 512², batch 4),
    depth 8, bf16, seeded weights and uint8 caches in memory. 14a: K1 and
    K2 against their plain versions at every 512² norm site of both models
    at batch 4 and 1, K1 also at the predict chunk of 16, with the columns
    of phases 3 and 6; both dtypes at the generator's 256²×64 site, whose
    bands exceed shared memory (its plan stages nothing), with its
    cudaOccupancyMaxActiveClusters and per-block timelines. 14b: S at every
    512² stem shape, as in phase 4. 14c and 14d: Pix2Pix and CycleGAN
    ``fit`` for one epoch at batch 4 (graph replays, a partial tail, a val
    pass), with ``--remat off`` and then ``--remat on`` from the same seeded
    state: launches counted on the card against the derivation (with remat
    the generators' backward recomputes each generator pass's stem and
    norms once), the checkpoint round trip, the two settings' losses,
    parameters and Adam states bit for bit, one step of the remat trainer
    through the kernels against the plain path, each setting's peak memory,
    graph step time and idle share; for CycleGAN also the batched form
    against the unbatched one (``check_forms``), the dgrad trace, both
    forms' graph steps at batch 1, 2 and 4 (``form_sweep``, each form's
    launches counted on the card; device time by group at 4), and both
    forms with remat on at batch 4 (their launches counted too). 14e: predict of
    both models on 32 images against the plain path. 14f: the remat
    frontier that ``use_remat`` rests on, graph step ms and peak memory
    (above what was allocated before each trainer) off and on, each
    capture epoch's launches counted on the card, for Pix2Pix
    at 512², batch 1, 4, 16 and 64, CycleGAN at 512², batch 1, 4, 16, 48, 64
    and 72, and Pix2Pix at 256², batch 128; per model the least-squares line
    of the remat-free peaks and the line of its slope that under-predicts
    no point. Alone, after the build: ``python3 -c "import
    chip_smoke as c, tempfile; c.tf32_off(); c.build.build();
    c.run_512(tempfile.mkdtemp(), 'card')"``.

15. data parallelism (gan_tpu_torch.parallel). 15a: a group of one rank
    over NCCL in this process; Pix2Pix at batch 32 (phase 10's data and
    seed) and CycleGAN at batch 8 (phase 7's), one ``fit`` epoch each
    through the DP path, equal to ``fit`` without replicas bit for bit
    (losses, parameters, Adam's state), the full steps graph replays with
    the all-reduces captured, launches counted on the card; then each
    model's graph step with and without the group in turns. 15b: two
    spawned ranks on the one card over gloo (the runner eager by the
    backend rule): Pix2Pix at 256², depth 8, bf16, a global batch of 4
    with cross-replica batch norm and injected dropout masks against one
    process at batch 4; at a global batch of 2 with per-replica batch norm
    (K1 and K2 at a batch of one, counted on the card) against the mean of
    two batch-1 steps, and against itself on the plain path; its step time,
    which measures no scaling; CycleGAN at a global batch of 2, one ``fit``
    epoch with a zip tail, the ranks' parameter checksums equal. 15c: the
    Pix2Pix CLI's path (``parallel.launch``, then the CLI's ``run`` on each
    rank, with the figures and grids stubbed: no matplotlib on the card's
    machine) at ``--num-devices`` min(cards, 4) over NCCL against one card,
    pairs/s per card, where the machine has two cards or more; else it
    prints that it did not run, and why. Alone, after the build:
    ``python3 -c "import chip_smoke as c, tempfile; c.tf32_off();
    c.build.build(); c.run_data_parallel(tempfile.mkdtemp(), 'card')"``.

16. the fault fence (gan_tpu_torch.train.recovery), each run a process of
    its own through the CLI's ``main`` (``fence_child``: figures and grids
    stubbed) on seeded noise PNGs, 4 epochs with ``--checkpoint-every 2``,
    the faults at the 2nd step of train epoch index 2, which replays the
    graph captured in epoch 0. 16a: CycleGAN at 256², depth 8, bf16, batch
    2, 8 images a domain: a clean run (its checkpoint saves in GB/s, no
    anchor left); a RuntimeError raised after the step, rewound in-process
    (one restore; the seconds from the fault to the end of the first step
    after the rewind, the restore's and the recapture's among them); a
    sticky fault, a ``__trap()`` kernel (``TRAP_SOURCE``, built with
    ``load_inline``) launched on the trainer's stream after the step,
    which must end in exit 17 within ``STICKY_EXIT_S`` with the resume
    line and no restore; then ``--resume`` of that run in a fresh process
    (the seconds from its start to its first step). 16b: Pix2Pix at 256²,
    batch 4, 16 pairs streamed from the files (``--host-cache off``), clean
    and with the RuntimeError. Each rewound or resumed run's metrics and
    final checkpoint are held to the clean run's bit for bit, or, where
    they differ, within the largest difference of two clean runs, which is
    then measured and printed. 16c: a step that raises while it is
    captured, and one whose capture a synchronisation invalidates, leave
    the current stream as it was and no stream capturing; a fresh runner
    then captures and replays. Alone, after the build: ``python3 -c
    "import chip_smoke as c, tempfile; c.tf32_off(); c.build.build();
    c.run_fence(tempfile.mkdtemp(), 'card')"``.

17. Adam's update (``gan_tpu_torch/csrc/adam.cu``, ``kernels.adam_step``)
    at both benchmark configurations' parameter lists (Pix2Pix 512²: the
    batch-norm U-Net and the conditional PatchGAN, 57.17 M parameters;
    CycleGAN 256²: two instance-norm U-Nets and two PatchGANs, 114.3 M), in
    the models' layouts: one update of the kernel from a seeded state
    (launch error checked, then a synchronisation) against the plain twin
    (``adam_update_plain``) and against ``torch.optim.Adam(capturable=True)``'s
    foreach step, in ulps; then the device time of each and of
    ``torch.optim.Adam(fused=True, capturable=True)``, the library kernel
    for this update, CUDA-graph replays timed with CUDA events, beside the
    28-byte bound (read p, g, m, v, write p, m, v) and the kernel's share
    of it. torch's Adams are yardsticks only: the port never calls their
    step on the card. The kernel's launches on the main paths are counted
    on the card in phases 5-16 (``adam_update``). Alone,
    after the build: ``python3 -c "import chip_smoke as c; c.tf32_off();
    c.build.build(); c.check_adam()"``.

The last lines are the kernels' JSON record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. Only phases 12 and 13 write PNGs, into
temporary directories.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

import torch.distributed as dist

from gan_tpu_torch import parallel
from gan_tpu_torch.config import parse_cyclegan, parse_pix2pix
from gan_tpu_torch.data import native, pipeline
from gan_tpu_torch.data.augment import normalize_batch, paired_jitter_batch, single_jitter_batch
from gan_tpu_torch.data.loader import DEVICE_CACHE_FRACTION, FileCache, device_bytes
from gan_tpu_torch import quality
from gan_tpu_torch.models import blocks, inception
from gan_tpu_torch.models.unet import _DOWN_FILTERS, _UP_SPECS
from gan_tpu_torch.ops import build, conv, kernels, norm
from gan_tpu_torch.train import base, loop, recovery
from gan_tpu_torch.train.base import generator_depth
from gan_tpu_torch.train.checkpoint import CheckpointManager, latest_checkpoint_dir
from gan_tpu_torch.train.cyclegan_trainer import NETWORKS as NETWORKS_CYCLEGAN
from gan_tpu_torch.train.cyclegan_trainer import (BATCHED_PASSES, UNBATCHED_PASSES,
                                                   CycleGANTrainer, batched_pass_max,
                                                   pass_widths)
from gan_tpu_torch.tools import eval_quality
from gan_tpu_torch.train.pix2pix_trainer import REMAT_FREE_PEAK, Pix2PixTrainer, use_remat
from gan_tpu_torch.utils import silence

IMG_SIZE = 256
BATCH = 16          # generate_batched's chunk
N_IMAGES = 32       # two generator passes
TRAIN_BATCH = 8     # the README's CycleGAN quick start
REF_BATCH = 4       # the reference's CycleGAN batch, inside the card's batched range at 256²
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
# Inception pool3 features, the card (TF32 off) against the CPU, relative to
# the largest feature: fp32 convs through 94 blocks, cuDNN's algorithms
# against the CPU's (the port against gan_tpu on the CPU: 9e-7).
FEATURE_TOL = 1e-4
N_QUALITY = 64      # images phase 12 generates and scores
# the reference corpus's files (rows, columns): tools/curate_flir.py writes
# each pair as two 512x640 halves side by side; CycleGAN's domains are the halves
REF_PAIR, REF_SINGLE = (512, 1280), (512, 640)
ONE_THREAD_FILES = 64   # files each single-threaded decode reading of phase 13a takes


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
GRAPH_STEPS = 8     # graph replays per timed call of the graph path
P2P_BENCH_BATCH = 128   # bench.py:80's per-chip Pix2Pix batch
SOURCES = {"instance_norm_fwd": "gan_tpu_torch/csrc/instance_norm.cu",
           "instance_norm_bwd": "gan_tpu_torch/csrc/instance_norm.cu",
           "stem_conv": "gan_tpu_torch/csrc/stem_conv.cu",
           "adam_update": "gan_tpu_torch/csrc/adam.cu"}
REPLACES = {"instance_norm_fwd": "gan_tpu/ops/pallas_kernels.py:89",
            "instance_norm_bwd": "gan_tpu/ops/pallas_kernels.py:128",
            "stem_conv": "benchmarks/pallas_stem_proto.py:46",
            "adam_update": "none (gan_tpu/train/optim.py: optax under XLA)"}
PIX2PIX_STEMS_PER_STEP = 3   # G(x), D(x, y), D(x, G(x)): one stem each
# the batches at which both CycleGAN forms are timed at each image size (phases
# 8c and 14d): the sweep that sets the card's crossover (``batched_pass_max``)
FORM_BATCHES = {256: (1, 2, 4, 8, 16, 32), 512: (1, 2, 4)}
# phase 14: the 512² configuration, the reference's one published Pix2Pix run
# (512², batch 4, SURVEY.md:460); CycleGAN at the same batch
IMG_512 = 512
BATCH_512 = 4
N_512_TRAIN, N_512_VAL = 13, 6   # 3 full steps + a 1-row tail; 1 full step + 2 rows
N_512_X, N_512_Y = 10, 12        # 2 full steps + a zip tail of 2 X and 4 Y rows
# (model, image size, batch) of the remat frontier (14f), off and on
FRONTIER = (("pix2pix", IMG_512, 1), ("pix2pix", IMG_512, 4), ("pix2pix", IMG_512, 16),
            ("pix2pix", IMG_512, 64), ("cyclegan", IMG_512, 1), ("cyclegan", IMG_512, 4),
            ("cyclegan", IMG_512, 16), ("cyclegan", IMG_512, 48), ("cyclegan", IMG_512, 64),
            ("cyclegan", IMG_512, 72), ("pix2pix", IMG_SIZE, P2P_BENCH_BATCH))
FRONTIER_STEPS = 3   # graph steps per timed epoch of the frontier


def disc_norm_sites(img_size: int) -> tuple:
    """(H = W, C) of each norm in the PatchGAN, in call order: down_1 at
    img/4, down_2 at img/8, the 512-channel conv's VALID output at img/8 − 1."""
    return ((img_size // 4, 128), (img_size // 8, 256), (img_size // 8 - 1, 512))


DISC_NORM_SITES = disc_norm_sites(IMG_SIZE)


def cyclegan_steps(img_size: int) -> list[tuple[int, int, int]]:
    """(bx, by, BATCHED_PASS_MAX) of each CycleGAN train step the paths run
    at ``img_size``: fit's full steps and its zip tail (phases 7, 13c,
    14d), the full step in both forms (the forms' gate), and both forms at
    every batch of FORM_BATCHES (the forms' step times)."""
    limit = batched_pass_max(img_size)
    (nx, ny, b) = (N_TRAIN_X, N_TRAIN_Y, TRAIN_BATCH) if img_size == IMG_SIZE else (
        N_512_X, N_512_Y, BATCH_512)
    tail = (nx % b, min(b, ny - nx // b * b))
    return [(b, b, limit), (*tail, limit)] + [
        (n, n, form) for n in sorted({b, *FORM_BATCHES[img_size]}) for form in (n, -1)]


def cyclegan_batches(img_size: int) -> tuple[set, set]:
    """The batches of every generator and every discriminator pass of the
    CycleGAN train steps the paths run at ``img_size`` (``cyclegan_steps``)."""
    gen, disc = set(), set()
    for bx, by, limit in cyclegan_steps(img_size):
        if max(bx, by) <= limit:
            gen |= set(pass_widths(BATCHED_PASSES, bx, by))
            disc.add(bx + by)
        else:
            gen |= set(pass_widths(UNBATCHED_PASSES, bx, by))
            disc |= {bx, by}
    return gen, disc


def stem_shapes(img_size: int) -> dict:
    """(batch, C_in) of every stem the paths run at ``img_size`` (256 or
    512) -> (what runs it, the gradient its training step takes: None for a
    forward only, False for dw, True for dx and dw, since D's input holds
    the fake and F's batched pass holds fake_y). CycleGAN's stems run at
    every batch of ``cyclegan_batches``; its 3-channel form at the batched
    form's widths is checked forward only."""
    if img_size == IMG_SIZE:
        shapes = {(P2P_BATCH, 1): ("Pix2Pix G, train step", False),
                  (P2P_BATCH, 2): ("Pix2Pix D on (input, target), train step", True),
                  (BATCH, 1): ("predict chunk, both models", None),
                  (TRAIN_BATCH, 3): ("3-channel G and CycleGAN D", None),
                  (TRAIN_BATCH, 6): ("3-channel Pix2Pix D", None)}
        batch = TRAIN_BATCH
    else:
        shapes = {(BATCH_512, 1): ("Pix2Pix G, train step", False),
                  (BATCH_512, 2): ("Pix2Pix D on (input, target), train step", True),
                  (BATCH, 1): ("predict chunk, both models", None),
                  (1, 1): ("Pix2Pix G at batch 1", False),
                  (1, 2): ("Pix2Pix D at batch 1", True),
                  (BATCH_512, 3): ("3-channel G and CycleGAN D", None),
                  (BATCH_512, 6): ("3-channel Pix2Pix D", None)}
        batch = BATCH_512
    gen, disc = cyclegan_batches(img_size)
    for n in sorted(gen | disc):
        use = shapes.get((n, 1), ("", None))[0]
        shapes[n, 1] = ((use + "; " if use else "") + "CycleGAN G and D passes, train step", True)
    for n in pass_widths(BATCHED_PASSES, batch, batch):
        shapes.setdefault((n, 3), ("3-channel CycleGAN G, batched pass", None))
    return shapes


_STARTED = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name} (at {time.perf_counter() - _STARTED:.1f} s)", flush=True)


def norm_sites(img_size: int, depth: int) -> list[tuple[int, int]]:
    """(H = W, C) of each norm in the generator, in call order."""
    down = [(img_size >> (i + 1), f) for i, f in enumerate(_DOWN_FILTERS[:depth])][1:]
    up_specs = _UP_SPECS[len(_UP_SPECS) - (depth - 1):]
    up = [(img_size >> (depth - 1 - i), f) for i, (f, _drop) in enumerate(up_specs)]
    return down + up


def cyclegan_batched(img_size: int, batch: int) -> bool:
    """Whether a CycleGAN step at ``img_size`` whose wider domain has
    ``batch`` rows runs gan_tpu's batched form (``CycleGANTrainer.passes``
    with its switch at the card's crossover)."""
    return batch <= batched_pass_max(img_size)


def cyclegan_passes(batched: bool) -> tuple[int, int]:
    """(generator passes, discriminator passes) of a CycleGAN step: 3 U-Net
    passes and D_x and D_y each on real and fake at once in the batched
    form, 6 and 4 in the unbatched one."""
    return (len(BATCHED_PASSES), 2) if batched else (len(UNBATCHED_PASSES), 4)


def train_step_launches(gen_norms: int, disc_norms: int, batched: bool,
                        remat: bool = False) -> tuple[int, int]:
    """(K1, K2) launches of one CycleGAN train step in either form, from its
    structure (``cyclegan_passes``).

    K1: every norm of every generator and discriminator pass. K2: one
    backward through every norm on a path from a gradient group's objective
    to the group's parameters. Each group's ``autograd.grad`` is one graph
    task, which walks each node once:
      the generators: every generator pass, and the D_x and D_y passes that
      hold fake_x and fake_y (both batched passes, or the two unbatched
      passes on the fakes);
      the discriminators: every discriminator pass, stopping at its input.
    With ``remat`` the generators' walk first recomputes each generator
    pass's checkpointed blocks, once (one task): their norms run K1 once
    more; K2 is unchanged.
    """
    gen, disc = cyclegan_passes(batched)
    k1 = gen * gen_norms * (2 if remat else 1) + disc * disc_norms
    return k1, gen * gen_norms + 2 * disc_norms + disc * disc_norms


def cyclegan_launches(img_size: int, batched: bool, remat: bool = False) -> tuple[dict, dict]:
    """Each kernel's launches in one CycleGAN train step and in one val
    step at ``img_size`` in either form: the norms as
    ``train_step_launches`` derives them, a stem per network pass, and with
    ``remat`` a stem per recomputed generator pass."""
    gen, disc = len(norm_sites(img_size, generator_depth(img_size))), len(disc_norm_sites(img_size))
    k1, k2 = train_step_launches(gen, disc, batched, remat)
    gen_passes, disc_passes = cyclegan_passes(batched)
    stems = gen_passes * (2 if remat else 1) + disc_passes
    return ({"instance_norm_fwd": k1, "instance_norm_bwd": k2, "stem_conv": stems},
            {"instance_norm_fwd": gen_passes * gen + disc_passes * disc, "instance_norm_bwd": 0,
             "stem_conv": gen_passes + disc_passes})


def pix2pix_launches(img_size: int, batch: int, training: bool, remat: bool = False) -> dict:
    """Each kernel's launches in one Pix2Pix step of ``batch`` rows: a stem
    for G and one for each D pass. Batch norm runs K1 only on a batch of
    one, per image, at G's norms and at each D pass's; a train step then
    runs K2 through every norm on a path to a network's parameters: G's and
    D(x, fake)'s for the generator, both D passes' for the discriminator.
    With ``remat`` the generator's backward first recomputes G's blocks:
    its stem, and on a batch of one its norms, once more."""
    gen, disc = len(norm_sites(img_size, generator_depth(img_size))), len(disc_norm_sites(img_size))
    per_image = batch == 1
    recompute = remat and training
    return {"instance_norm_fwd": (gen + 2 * disc + (gen if recompute else 0)) if per_image else 0,
            "instance_norm_bwd": gen + 3 * disc if per_image and training else 0,
            "stem_conv": PIX2PIX_STEMS_PER_STEP + (1 if recompute else 0)}


def with_adam(per_train: dict, per_val: dict, trainer) -> tuple[dict, dict]:
    """``per_train`` and ``per_val`` with Adam's update kernel: a train step
    launches it once per ``kernels.ADAM_TENSORS`` of the tensors of
    ``trainer``'s optimizers (``kernels.adam_launches``), a val step never."""
    tensors = sum(len(g["params"]) for opt in trainer.opts.values() for g in opt.param_groups)
    return (dict(per_train, adam_update=kernels.adam_launches(tensors)),
            dict(per_val, adam_update=0))


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


K1_HEADER = (f"{'N,H,W,C':>18} {'dtype':>9} {'act':>10} {'eps':>6} {'max_abs_err':>12} "
             f"{'tol(atol,rtol)':>16} {'plan':>14} {'kernel_us':>10} {'plain_us':>10} "
             f"{'library_us':>10} {'bound_us':>9} {'share':>7} {'k/lib':>6}")


def k1_row(n: int, hw: int, c: int, dtype, act, eps, g) -> tuple[float, tuple]:
    """K1 against its plain version on seeded (n, hw, hw, c) inputs, and the
    device time of both, of the library and the bound; prints one row of
    K1_HEADER. Returns the largest error and (kernel, plain, library,
    bound) ms."""
    plan = kernels.norm_plan(n, hw * hw, c, dtype)
    x = (torch.randn(n, hw, hw, c, device="cuda", generator=g) * 3.0 + 1.0).to(dtype)
    scale = 1.0 + 0.02 * torch.randn(c, device="cuda", generator=g)
    offset = 0.1 * torch.randn(c, device="cuda", generator=g)
    got = kernels.instance_norm(x, scale, offset, act=act, eps=eps)
    torch.cuda.synchronize()
    want = norm.instance_norm(x, scale, offset, act=act, eps=eps)
    err = (got.float() - want.float()).abs().max().item()
    atol, rtol = KERNEL_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    k_ms = device_ms(lambda: kernels.instance_norm(x, scale, offset, act=act, eps=eps))
    p_ms = device_ms(lambda: norm.instance_norm(x, scale, offset, act=act, eps=eps))
    lib_ms = device_ms(lambda: library_fwd(x, scale, offset, act, eps))
    b_ms, _ = bound_ms(2 * x.numel() * x.element_size())
    print(f"{f'{n},{hw},{hw},{c}':>18} {str(dtype)[6:]:>9} {str(act):>10} "
          f"{eps:>6g} {err:>12.3e} {f'{atol:g},{rtol:g}':>16} {_plan_str(plan):>14} "
          f"{k_ms * 1e3:>10.2f} {p_ms * 1e3:>10.2f} {lib_ms * 1e3:>10.2f} "
          f"{b_ms * 1e3:>9.2f} {b_ms / k_ms:>7.1%} {k_ms / lib_ms:>6.2f}", flush=True)
    return err, (k_ms, p_ms, lib_ms, b_ms)


def check_kernel(sites) -> dict:
    """Phase 3. Returns per-shape times and the largest error. Rows with
    eps 1e-3 are per-image batch norm (Pix2Pix's predict). plan: blocks per
    cluster / channel tile / shared-memory bytes; share: bound over kernel
    time; k/lib: kernel over library time."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = sorted(set(sites))
    times, worst = {}, 0.0
    print(L2_NOTE)
    print(K1_HEADER)
    for hw, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for act, eps in [(act, norm.IN_EPS) for act in norm.ACTS] + [(None, norm.BN_EPS)]:
                err, times[(hw, c, dtype, act, eps)] = k1_row(BATCH, hw, c, dtype, act, eps, g)
                worst = max(worst, err)
    hw, c = max(shapes, key=lambda s: s[0] * s[0] * s[1])
    print_max_clusters(BATCH, hw, c, backward=False)
    print(f"plans at {BATCH},{hw},{hw},{c} bf16, K1:")
    plan_sweep(BATCH, hw, c, backward=False)
    return {"times": times, "max_abs_err": worst}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def stem_hmma_counts() -> dict:
    """HMMA (tensor-core) instructions per stem kernel in the SASS of the
    built library (``cuobjdump --dump-sass``), by mangled symbol: the bf16
    route's ``stem_conv_mma_kernel`` instances and the fp32 route's
    ``stem_conv_kernel``."""
    path, _ = build.build()
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "--dump-sass", path],
                          capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            if "stem_conv" in current:
                counts[current] = 0
        elif current in counts and "HMMA" in line:
            counts[current] += 1
    return counts


def _stem_plan_str(plan) -> str:
    """rows/warps/pitch/load width/shared bytes"""
    return f"{plan.rows_per_block}/{plan.warps}/{plan.pitch}/{plan.vec}/{plan.smem_bytes}"


def check_stem(img_size: int = IMG_SIZE) -> dict:
    """Phase 4 (and 14b at 512²): S against its plain version at every stem
    shape of the paths at ``img_size``, forward in both dtypes and backward
    at the training shapes, with
    each launch's plan (rows/warps/pitch/vec/shared bytes), the share of
    the bound and the kernel/library ratio; first the HMMA count of each
    stem kernel's SASS (the bf16 route must have tensor-core instructions).
    Returns per-shape (kernel, plain, library, bound) times, bound kinds and
    the largest forward error."""
    hmma = stem_hmma_counts()
    for sym, count in sorted(hmma.items()):
        print(f"HMMA instructions in the SASS of {sym}: {count}")
    mma = {sym: c for sym, c in hmma.items() if "stem_conv_mma_kernel" in sym}
    if len(mma) != len(kernels.STEM_CHANNELS) or not all(mma.values()):
        raise AssertionError(f"the bf16 stem kernels have no tensor-core instructions: {hmma}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    times, bound_by, worst = {}, {}, 0.0
    print(L2_NOTE)
    print(f"{'N,H,W,C_in':>16} {'dtype':>9} {'max_abs_err':>12} {'tol(atol,rtol)':>20} "
          f"{'plan':>22} {'kernel_us':>10} {'plain_us':>10} {'library_us':>10} {'bound_us':>9} "
          f"{'share':>7} {'k/lib':>6} {'dx_rel':>9} {'dw_rel':>9}  path")
    for (n, c_in), (use, train) in stem_shapes(img_size).items():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.rand(n, img_size, img_size, c_in, device="cuda", generator=g) * 2 - 1).to(dtype)
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
            if train is not None:
                needs_dx = train
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
            plan = kernels.stem_plan(n, img_size, img_size, c_in, dtype)
            print(f"{f'{n},{img_size},{img_size},{c_in}':>16} {str(dtype)[6:]:>9} {err:>12.3e} "
                  f"{f'{atol:g},{rtol:g}':>20} {_stem_plan_str(plan):>22} {k_ms * 1e3:>10.2f} "
                  f"{p_ms * 1e3:>10.2f} {lib_ms * 1e3:>10.2f} {b_ms * 1e3:>9.2f} "
                  f"{b_ms / k_ms:>7.1%} {k_ms / lib_ms:>6.2f} {grads[0]:>9} {grads[1]:>9}  "
                  f"{use} (bound by {by})", flush=True)
    return {"times": times, "bound_by": bound_by, "max_abs_err": worst}


K2_HEADER = (f"{'N,H,W,C':>18} {'dtype':>9} {'dx_err':>10} {'dscale_err':>10} "
             f"{'doffset_err':>11} {'tol(dx;sums)':>20} {'k1_err':>9} {'plan':>14} "
             f"{'kernel_us':>10} {'plain_us':>10} {'library_us':>10} {'bound_us':>9} "
             f"{'share':>7} {'k/lib':>6}")


def k2_row(n: int, hw: int, c: int, dtype, g) -> tuple[float, tuple]:
    """K2 (and K1) against the plain versions on seeded (n, hw, hw, c)
    inputs, and K2's device time, the plain version's, the library's
    backward and the bound; prints one row of K2_HEADER. Returns K2's largest
    error and (kernel, plain, library, bound) ms."""
    shape = (n, hw, hw, c)
    plan = kernels.norm_plan(n, hw * hw, c, dtype, backward=True)
    x = (torch.randn(shape, device="cuda", generator=g) * 3.0 + 1.0).to(dtype)
    scale = 1.0 + 0.02 * torch.randn(c, device="cuda", generator=g)
    offset = 0.1 * torch.randn(c, device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    got = kernels.instance_norm_backward(x, scale, dy)
    y = kernels.instance_norm(x, scale, offset)
    torch.cuda.synchronize()
    want = norm.instance_norm_backward(x, scale, dy)
    atol, rtol = KERNEL_TOL[dtype]
    s_tol = sums_tol(n * hw * hw)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=rtol)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=s_tol, rtol=1e-5)
    y_want = norm.instance_norm(x, scale, offset)
    torch.testing.assert_close(y.float(), y_want.float(), atol=atol, rtol=rtol)
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    k1_err = (y.float() - y_want.float()).abs().max().item()
    k_ms = device_ms(lambda: kernels.instance_norm_backward(x, scale, dy))
    p_ms = device_ms(lambda: norm.instance_norm_backward(x, scale, dy))
    lib_ms = library_bwd_ms(x, scale, offset, dy)
    b_ms, _ = bound_ms(3 * x.numel() * x.element_size())
    print(f"{','.join(map(str, shape)):>18} {str(dtype)[6:]:>9} {errs[0]:>10.3e} "
          f"{errs[1]:>10.3e} {errs[2]:>11.3e} {f'{atol:g},{rtol:g};{s_tol:.3g}':>20} "
          f"{k1_err:>9.2e} {_plan_str(plan):>14} {k_ms * 1e3:>10.2f} {p_ms * 1e3:>10.2f} "
          f"{lib_ms * 1e3:>10.2f} {b_ms * 1e3:>9.2f} {b_ms / k_ms:>7.1%} "
          f"{k_ms / lib_ms:>6.2f}", flush=True)
    return max(errs), (k_ms, p_ms, lib_ms, b_ms)


def check_backward(shapes, batched: list) -> dict:
    """Phase 6: K2 (and K1) against their plain versions at batch 8 in both
    dtypes, and at the (N, H = W, C) of ``batched`` in bf16 (the CycleGAN
    batched form's wider passes). Returns per-shape K2 times at batch 8 and
    the largest error. Columns as in phase 3."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    times, worst = {}, 0.0
    print(L2_NOTE)
    print(K2_HEADER)
    for hw, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            err, times[(hw, c, dtype)] = k2_row(TRAIN_BATCH, hw, c, dtype, g)
            worst = max(worst, err)
    for n, hw, c in batched:
        worst = max(worst, k2_row(n, hw, c, torch.bfloat16, g)[0])
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
_GROUPS = (("stem conv (CUDA kernel S)", ("stem_conv_kernel", "stem_conv_mma_kernel")),
           ("instance norm forward (CUDA kernel K1)", ("instance_norm_fwd_kernel",)),
           ("instance norm backward (CUDA kernel K2)", ("instance_norm_bwd_kernel",)),
           ("batch norm (PyTorch's kernels)", ("batch_norm", "bn_fw", "bn_bw", "welford")),
           ("Adam (multi-tensor)", ("multi_tensor_apply",)),
           ("dtype casts and copies", ("copy_kernel",)),
           ("cat of skips", ("CatArrayBatchedCopy",)),
           ("cuDNN convs, transposed convs and their layout kernels",
            ("xmma", "cutlass", "cudnn", "conv", "Nhwc", "Nchw", "wgrad", "dgrad")))


def profile_device(fn, calls: int, steps: int = 1) -> tuple[float, float]:
    """Device µs per step by kernel group, from a torch.profiler trace of
    ``calls`` calls of ``fn``, each ``steps`` steps; prints the groups and
    the 8 longest kernels. Returns the summed kernel µs and the kernels and
    copies per step."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    groups, kernels_us, launched = {}, {}, 0
    per = calls * steps
    for e in prof.events():
        # device-side ranges of annotations (Optimizer.step#Adam.step) span
        # kernels counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.name.startswith("Optimizer.")):
            continue
        us = e.time_range.elapsed_us() / per
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
    print(f"  {launched / per:10.1f} device kernels and copies per step")
    return sum(groups.values()), launched / per


def device_launches(fn):
    """``fn()``, and how often the card ran each kernel of the paths during
    it, counted by the kernels themselves (``kernels.card_launches``): a
    CUDA-graph replay calls no wrapper, so the wrappers' counts
    (``kernels.LAUNCHES``) see only the steps the host ran or captured. A
    torch.profiler trace is no such count: the card's kernel records reach
    it through a buffer that may lose one (a trace of a predict once held
    3 S where the wrappers and the outputs showed 4)."""
    torch.cuda.synchronize()
    before = kernels.card_launches()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.card_launches()
    return out, {name: after[name] - before[name] for name in after}


def eager_paths(fn) -> dict:
    """The kernel and the plain path of an eager ``fn``: label -> (fn, steps
    per call, context)."""
    return {"kernel": (fn, 1, contextlib.nullcontext),
            "plain": (fn, 1, lambda: plain_path("plain"))}


def timed_paths(paths: dict, rounds: int, reps: int) -> dict:
    """Median eager times of one step per path, the paths in turns."""
    runs = {label: [] for label in paths}
    order = list(paths)
    for labels in (order, order[::-1]) * rounds:
        for label in labels:
            fn, steps, context = paths[label]
            with context():
                runs[label].append(median_ms(fn, reps=reps) / steps)
    return runs


def profile_paths(paths: dict, calls: int, runs: dict, what: str) -> dict:
    """Each path's profile, with the card's idle share of its median step.
    Returns label -> (device µs, kernels per step, idle share)."""
    out = {}
    for label, (fn, steps, context) in paths.items():
        print(f"{label} path, device time per {what}:")
        with context():
            busy_us, per_step = profile_device(fn, calls, steps)
        step_ms = float(np.median(runs[label]))
        idle = 1 - busy_us / 1e3 / step_ms
        print(f"  {busy_us:10.2f} us  sum of kernel time; {what} median {step_ms:.3f} ms, "
              f"so the card is idle {idle:.1%} of it")
        out[label] = (busy_us, per_step, idle)
    return out


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
    fp32, then the predict rate, at the size of the images ``u8``. Returns
    the launches and the output."""
    size = u8.shape[1]
    seen = set()
    for m in trainer.sampler.modules():
        if isinstance(m, norm_type):
            m.register_forward_hook(lambda mod, inp, o: seen.add(tuple(inp[0].shape[1:])))
    passes = -(-u8.shape[0] // BATCH)
    kernels.reset_launches()
    pred, launches = device_launches(lambda: trainer.generate_batched(u8, chunk=BATCH))
    host = dict(kernels.LAUNCHES)
    want = {"instance_norm_fwd": 14 * passes, "instance_norm_bwd": 0, "stem_conv": passes,
            "adam_update": 0}
    print(f"launches on the predict path, counted on the card: {launches} over {passes} "
          f"generator passes, expected {want}; by the wrappers: {host}")
    if launches != want or host != want:
        raise AssertionError("launch counts differ from the generator's structure")
    want_sites = {(hw, hw, c) for hw, c in norm_sites(size, generator_depth(size))}
    if seen != want_sites:
        raise AssertionError(f"norm shapes {sorted(seen)} != compared {sorted(want_sites)}")
    if pred.shape != (u8.shape[0], size, size, 1) or pred.dtype != np.float32:
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
    print(f"predict {u8.shape[0]} images at {size}² bf16: {e2e * 1e3:.2f} ms "
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

    fwd_runs = timed_paths(eager_paths(fwd), rounds=4, reps=10)
    for label, runs_ms in fwd_runs.items():
        print(f"generator forward, batch {BATCH} resident on the card, {label} path: "
              f"median {np.median(runs_ms):.3f} ms (rounds {[round(r, 3) for r in runs_ms]})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase(f"5b. profile: CycleGAN generator forward, batch {BATCH} resident on the card")
    profile_paths(eager_paths(fwd), 5, fwd_runs, "forward")
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


def check_fit(trainer, make_trainer, fit, want: dict, want_host: dict, want_epoch: dict,
              steps: int, floor: int) -> tuple[dict, float]:
    """``fit`` (one epoch, its full steps as CUDA-graph replays) with the
    kernels' launches counted on the card against the derivation ``want``,
    the wrappers' counts against ``want_host`` (the steps the host ran or
    captured) and the runners' eager steps, captures and replays against
    ``want_epoch``; finite losses, every network changed, Adam's step count
    equal to the steps trained (no warm-up leaked), and a checkpoint round
    trip of every network and Adam. Returns the launches and the peak device
    memory above ``floor``, the bytes allocated before the trainer was built
    (``reset_memory``)."""
    before = {k: [p.detach().cpu() for p in v] for k, v in trainer.params.items()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    (train_cost, val_cost, mgr), launches = device_launches(fit)
    fit_s = time.perf_counter() - t0
    host = dict(kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - floor) / 2**30
    captures = ", ".join(f"{'train' if key[0] else 'val'} {runner.capture_s:.2f} s"
                         for key, (runner, _, _) in trainer._runners.items())
    print(f"fit: {fit_s:.2f} s with the set-up; launches counted on the "
          f"card {launches}, expected {want}; by the wrappers {host}, expected {want_host}; "
          f"runner steps {trainer.epoch_counts}, expected {want_epoch}; graph captures: "
          f"{captures}; peak device memory {peak:.2f} GiB above the {floor / 2**30:.2f} GiB "
          "allocated before the trainer was built")
    if launches != want:
        raise AssertionError("launch counts differ from the step's derivation")
    if host != want_host or trainer.epoch_counts != want_epoch:
        raise AssertionError("the runners ran other steps eagerly or as replays than expected")
    for k in train_cost:
        print(f"  {k}: train {train_cost[k][0]:.4f}, val {val_cost[k][0]:.4f}")
    if not all(math.isfinite(v[0]) for d in (train_cost, val_cost) for v in d.values()):
        raise AssertionError("a loss is not finite")
    unchanged = [k for k in trainer.nets
                 if all(torch.equal(a, b.cpu()) for a, b in zip(before[k], trainer.params[k]))]
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


def epoch_plan_counts(per_train: dict, per_val: dict, train: tuple, val: tuple,
                      tails: tuple | None = None):
    """What one epoch of ``fit`` should run, from (full steps, tail rows) of
    the train and the val epoch: the card runs every step's kernels
    (``per_train``, ``per_val`` per full step; ``tails``, a (train, val)
    pair, per tail step where a tail runs other kernels, as Pix2Pix's
    batch of one does); the host traces them only where a runner runs its
    first step eagerly (the capture's warm-up), captures it, or runs a
    tail; the other full steps are replays. Returns the device launches,
    the wrappers' launches and the runners' counts."""
    ran = {n: 0 for n in per_train}
    traced = {n: 0 for n in per_train}
    counts = {"eager": 0, "captures": 0, "replays": 0}
    for per, tail_per, (full, tail) in zip((per_train, per_val), tails or (per_train, per_val),
                                           (train, val)):
        for n in per:
            ran[n] += per[n] * full + tail_per[n] * (tail > 0)
            traced[n] += per[n] * (2 if full else 0) + tail_per[n] * (tail > 0)
        if full:
            counts["eager"] += 1
            counts["captures"] += 1
            counts["replays"] += full - 1
    return ran, traced, counts


def copy_state(trainer) -> dict:
    """The trainer's state through a buffer, as ``--resume`` loads it: the
    copy shares no tensor with the trainer (an Adam's ``load_state_dict``
    keeps tensors that are on the right device already)."""
    buf = io.BytesIO()
    torch.save(trainer.state(), buf)
    buf.seek(0)
    return torch.load(buf, map_location="cpu", weights_only=True)


def check_graph_step(fitted, make_trainer, caches: tuple, batch: int):
    """Two steps of the epoch runner (the first eager as the capture's
    warm-up, the second a graph replay) against two eager ``_step``s, from
    the fitted state and on the same rows and draws: the losses within
    ``STEP_TOL``'s bf16 loss tolerance (relative), each network's parameter
    update within its gradient tolerance (relative L2). The same kernels run
    in the same order; cuDNN's weight gradients may sum in another order.
    Returns the graph trainer."""
    state = copy_state(fitted)
    graph, eager = make_trainer(), make_trainer()
    graph.load_state(state)
    eager.load_state(state)
    start = {k: torch.cat([p.detach().flatten().float() for p in v])
             for k, v in graph.params.items()}
    rows = tuple(torch.arange(2 * batch, device="cuda").view(2, batch) for _ in caches)
    got = graph._cached_epoch(caches, rows, 0, True)
    want = torch.stack([eager._step(*(c.index_select(0, r[s]) for c, r in zip(caches, rows)),
                                    0, 0, s) for s in range(2)])
    loss_err = ((got - want).abs() / want.abs()).max().item()
    upd_err = {}
    for k in graph.params:
        moved = [torch.cat([p.detach().flatten().float() for p in t.params[k]]) - start[k]
                 for t in (graph, eager)]
        upd_err[k] = _rel(moved[0], moved[1])
    upd = ", ".join(f"{k} {v:.3e}" for k, v in upd_err.items())
    print(f"graph step vs eager step (2 steps from the fitted state; the second a replay): "
          f"losses {got[1].tolist()} vs {want[1].tolist()}, max relative error {loss_err:.3e} "
          f"(tol {STEP_TOL['bf16'][0]:g}); parameter updates, relative L2 error: {upd} "
          f"(tol {STEP_TOL['bf16'][1]:g}); runner {graph.epoch_counts}, capture "
          f"{next(iter(graph._runners.values()))[0].capture_s:.2f} s")
    if graph.epoch_counts != {"eager": 1, "captures": 1, "replays": 1}:
        raise AssertionError("the runner did not replay its second step")
    if loss_err > STEP_TOL["bf16"][0] or max(upd_err.values()) > STEP_TOL["bf16"][1]:
        raise AssertionError("graph step disagrees with the eager step")
    del eager
    return graph


def unbatched_masks(masks: list, bx: int, by: int) -> list:
    """The batched form's keep-masks (``StepDraws.masks``: one list per
    pass) cut into the unbatched form's (one list per application), so that
    every image keeps its mask."""
    width = {outputs[0]: w for (_, _, outputs), w in
             zip(UNBATCHED_PASSES, pass_widths(UNBATCHED_PASSES, bx, by))}
    cut = {}
    for (_, _, outputs), sites in zip(BATCHED_PASSES, masks):
        parts = [m.split([width[o] for o in outputs]) for m in sites]
        cut.update((o, [p[j] for p in parts]) for j, o in enumerate(outputs))
    return [cut[outputs[0]] for _, _, outputs in UNBATCHED_PASSES]


def check_forms(bf16, fp32, x, y) -> None:
    """Gate: one CycleGAN train step's losses and per-network gradients in
    gan_tpu's batched form against the unbatched form (``BATCHED_PASS_MAX``
    set to the batch, then to -1), from the same state and batch, the
    unbatched form taking the batched form's dropout masks cut per
    application; nothing is
    updated. Within ``STEP_TOL`` in bf16 and in fp32 (TF32 off): the same
    arithmetic per image, in convs of other batches, whose algorithms and
    sums may differ."""
    b = x.shape[0]
    for label, trainer, xs, ys in (("bf16", bf16, x, y), ("fp32", fp32, x.float(), y.float())):
        runs = []
        try:
            trainer.BATCHED_PASS_MAX = b
            masks = trainer._step_draws(0, 0, 0).masks
            runs.append(trainer.gradients(xs, ys, masks=masks))
            trainer.BATCHED_PASS_MAX = -1
            runs.append(trainer.gradients(xs, ys, masks=unbatched_masks(masks, b, b)))
        finally:
            del trainer.BATCHED_PASS_MAX
        (got, got_losses), (want, want_losses) = runs
        loss_err = ((got_losses - want_losses).abs() / want_losses.abs()).max().item()
        flat = lambda gs: torch.cat([g.flatten().float() for g in gs])
        grad_err = {k: _rel(flat(got[k]), flat(want[k])) for k in got}
        print(f"{label} step at batch {b}, batched form vs unbatched form: losses "
              f"{got_losses.tolist()} vs {want_losses.tolist()}, max relative error "
              f"{loss_err:.3e} (tol {STEP_TOL[label][0]:g}); gradient relative L2 error "
              f"{ {k: f'{v:.3e}' for k, v in grad_err.items()} } (tol {STEP_TOL[label][1]:g})")
        if loss_err > STEP_TOL[label][0] or max(grad_err.values()) > STEP_TOL[label][1]:
            raise AssertionError("the batched form's step disagrees with the unbatched form's")


FORM_ROUNDS = 3   # rounds of timed graph epochs per form, in turns there and back


def counted_epoch(epoch, per_step: dict, steps: int, what: str):
    """``epoch()``, an epoch of ``steps`` full train steps (a runner's
    warm-up step or replays; a capture runs nothing), with the kernels'
    launches counted on the card (``device_launches``) held to ``steps``
    times the derived ``per_step``."""
    out, got = device_launches(epoch)
    want = {name: n * steps for name, n in per_step.items()}
    print(f"{what}: launches counted on the card {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{what}: launch counts differ from the step's derivation")
    return out


def form_numbers(tmp: str, size: int, batch: int, profile: bool, remat: str = "off") -> dict:
    """The CycleGAN graph step in both forms at ``size`` and ``batch``: one
    fresh seeded trainer per form ('batched' with ``BATCHED_PASS_MAX`` set
    to the batch, 'unbatched' with -1) over the same resident rows; an
    epoch of GRAPH_STEPS steps that captures each graph, its launches
    counted on the card against the form's derivation (``counted_epoch``),
    then FORM_ROUNDS rounds of timed epochs of GRAPH_STEPS replays in turns
    (batched, unbatched, unbatched, batched), CUDA events around each.
    Prints ms and image-pairs/s per form with every reading, and with
    ``profile`` each form's device time per step by kernel group and the
    card's idle share. Returns the median ms per form."""
    trainers = {}
    for form, limit in (("batched", batch), ("unbatched", -1)):
        trainers[form] = seeded_trainer("cyclegan", gan_config("cyclegan", tmp, size, batch, remat))
        trainers[form].BATCHED_PASS_MAX = limit
    caches = tuple(torch.from_numpy(a).to("cuda") for a in train_caches(
        "cyclegan", (batch, batch), size, np.random.default_rng(SEED + 22)))
    rows = tuple(torch.arange(GRAPH_STEPS * batch, device="cuda").remainder(batch).view(
        GRAPH_STEPS, batch) for _ in caches)
    epochs = {form: functools.partial(t._cached_epoch, caches, rows, 1, True)
              for form, t in trainers.items()}
    for form, epoch in epochs.items():
        per_step = with_adam(cyclegan_launches(size, form == "batched", remat == "on")[0], {},
                             trainers[form])[0]
        losses = counted_epoch(epoch, per_step, GRAPH_STEPS,
                               f"{form} form, {size}² batch {batch}, remat {remat}")
        if not torch.isfinite(losses).all():
            raise AssertionError(f"{form} form: a loss is not finite")
    times = {form: [] for form in epochs}
    for _ in range(FORM_ROUNDS):
        for form in ("batched", "unbatched", "unbatched", "batched"):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            epochs[form]()
            end.record()
            end.synchronize()
            times[form].append(start.elapsed_time(end) / GRAPH_STEPS)
    med = {form: float(np.median(t)) for form, t in times.items()}
    for form, t in times.items():
        print(f"{form} form, graph step at {size}², batch {batch}, remat {remat}: median "
              f"{med[form]:.3f} ms (readings {[round(r, 3) for r in t]}), "
              f"{batch / med[form] * 1e3:.2f} image-pairs/s; runner {trainers[form].epoch_counts}")
    print(f"batched / unbatched step time at {size}², batch {batch}, remat {remat}: "
          f"{med['batched'] / med['unbatched']:.3f}")
    if profile:
        for form, epoch in epochs.items():
            print(f"{form} form, device time per train step:")
            busy_us, _ = profile_device(epoch, 1, GRAPH_STEPS)
            print(f"  {busy_us:10.2f} us  sum of kernel time; the card is idle "
                  f"{1 - busy_us / 1e3 / med[form]:.1%} of the {med[form]:.3f} ms step")
    return med


def form_sweep(tmp: str, size: int, profile_batch: int, smi: str) -> None:
    """Both forms' graph steps (``form_numbers``, remat off) at every batch
    of FORM_BATCHES[size], profiled at ``profile_batch``; then the table of
    their ratio and the batches where the batched form was the faster,
    beside the form ``fit`` runs there (``batched_pass_max``)."""
    meds = {}
    for batch in FORM_BATCHES[size]:
        print(f"both forms at {size}², batch {batch} ({smi}):")
        meds[batch] = form_numbers(tmp, size, batch, profile=batch == profile_batch)
        reset_memory()
    limit = batched_pass_max(size)
    print(f"\nCycleGAN graph step by form at {size}², remat off ({smi}):")
    print(f"{'batch':>6} {'batched_ms':>11} {'unbatched_ms':>13} {'ratio':>6} {'faster':>10} "
          f"{'fit runs':>10}")
    for batch, med in meds.items():
        faster = "batched" if med["batched"] < med["unbatched"] else "unbatched"
        print(f"{batch:>6} {med['batched']:>11.3f} {med['unbatched']:>13.3f} "
              f"{med['batched'] / med['unbatched']:>6.3f} {faster:>10} "
              f"{'batched' if batch <= limit else 'unbatched':>10}")
    won = [b for b, med in meds.items() if med["batched"] < med["unbatched"]]
    print(f"the batched form was faster at batch {won or 'none'}; fit runs it at batch <= "
          f"{limit} at {size}² (batched_pass_max)")


DGRAD = "dgrad2d_grouped_direct_kernel"   # the cuDNN kernel PERF.md asks about


def trace_dgrad(step) -> None:
    """Which convolutions launch cuDNN's ``DGRAD`` kernel: a torch.profiler
    trace of one eager ``step`` with its ops' input shapes recorded; per
    launching op and shapes, the launches and device µs, their sum and its
    share of the step's kernel time. Not a gate."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    calls, total_us, device_us = {}, 0.0, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and DGRAD in e.name:
            device_us += e.time_range.elapsed_us()
        for k in getattr(e, "kernels", []):
            total_us += k.duration
            if DGRAD in k.name:
                chain, p = [e.name], e.cpu_parent
                while p is not None and len(chain) < 3:
                    chain.append(p.name)
                    p = p.cpu_parent
                key = (" < ".join(chain), str(e.input_shapes)[:200])
                n, us = calls.get(key, (0, 0.0))
                calls[key] = (n + 1, us + k.duration)
    dgrad_us = sum(us for _, us in calls.values())
    print(f"{DGRAD} in one eager train step: {dgrad_us:.2f} us attributed to ops "
          f"({device_us:.2f} us among the device events), of {total_us:.2f} us of kernel time "
          f"attributed to ops ({dgrad_us / max(total_us, 1e-9):.1%}); by launching op (< its "
          "callers) and its input shapes:")
    for (chain, shapes), (n, us) in sorted(calls.items(), key=lambda kv: -kv[1][1]):
        print(f"  {us:10.2f} us  {n:3d} launches  {chain}  {shapes}")


def reset_memory() -> int:
    """Collects what earlier work left to the garbage collector, returns the
    allocator's cached blocks to the card and resets the peak. Returns the
    bytes still allocated: the floor that a peak reading of the work that
    follows subtracts."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gib(fn, context) -> float:
    """Peak device memory, GiB, over one call of ``fn`` (with everything else
    that is resident)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with context():
        fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def graph_numbers(graph, eager_step, caches: tuple, batch: int, phase8: dict, what: str) -> None:
    """The graph path's step time, rate, device time, idle share, kernels
    per step and peak memory, timed in turns with the eager kernel path (an
    epoch of GRAPH_STEPS replays per call, divided by the steps), beside
    phase 8's eager kernel and plain paths."""
    rows = tuple(torch.arange(GRAPH_STEPS * batch, device="cuda").remainder(c.shape[0]).view(
        GRAPH_STEPS, batch) for c in caches)
    paths = {"graph": (lambda: graph._cached_epoch(caches, rows, 1, True), GRAPH_STEPS,
                       contextlib.nullcontext),
             **eager_paths(eager_step)}
    runs = timed_paths({label: paths[label] for label in ("graph", "kernel")}, rounds=3, reps=3)
    prof = profile_paths({"graph": paths["graph"]}, 1, runs, "train step")
    g_ms, k_ms = (float(np.median(runs[label])) for label in ("graph", "kernel"))
    print(f"train step, graph path: median {g_ms:.3f} ms (rounds "
          f"{[round(r, 3) for r in runs['graph']]}), {batch / g_ms * 1e3:.2f} {what}/s; "
          f"eager kernel path in the same rounds: median {k_ms:.3f} ms, "
          f"{batch / k_ms * 1e3:.2f} {what}/s")
    table = [("graph", g_ms, *prof["graph"])] + [
        (label, float(np.median(phase8["runs"][label])), *phase8["profile"][label])
        for label in ("kernel", "plain")]
    print(f"{'path':>8} {'step_ms':>9} {what + '/s':>14} {'device_ms':>10} {'idle':>7} "
          f"{'kernels/step':>13} {'peak_GiB':>9}  (peak: one call, both trainers resident)")
    for label, ms, us, per, idle in table:
        fn, _, context = paths[label]
        print(f"{label:>8} {ms:>9.3f} {batch / ms * 1e3:>14.2f} {us / 1e3:>10.3f} "
              f"{idle:>7.1%} {per:>13.1f} {peak_gib(fn, context):>9.2f}"
              + ("" if label == "graph" else "  (phase 8's rounds)"))


def step_numbers(step, batch: int, peak: float, what: str) -> dict:
    """The median eager step time per path in alternating rounds, images/s,
    and a profile of two steps per path. Returns the rounds and profiles."""
    paths = eager_paths(step)
    runs = timed_paths(paths, rounds=3, reps=5)
    for label, runs_ms in runs.items():
        med = float(np.median(runs_ms))
        print(f"train step, {label} path: median {med:.3f} ms "
              f"(rounds {[round(r, 3) for r in runs_ms]}), {batch / med * 1e3:.2f} {what}/s")
    print(f"peak device memory of fit {peak:.2f} GiB")
    return {"runs": runs, "profile": profile_paths(paths, 2, runs, "train step")}


def run_training(tmp: str, smi: str) -> dict:
    """Phases 7 and 8. Returns the kernel launch counts of the main-path runs
    (the ``fit`` epochs of 7 and 8d)."""
    argv = ["--input-images", tmp, "--target-images", tmp, "--output", tmp, "--train",
            "--epochs", "1", "--img-size", str(IMG_SIZE), "--batch-size", str(TRAIN_BATCH),
            "--dtype", "bf16"]
    cfg = parse_cyclegan(argv)
    floor = reset_memory()
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
    per_train, per_val = with_adam(
        *cyclegan_launches(IMG_SIZE, cyclegan_batched(IMG_SIZE, TRAIN_BATCH)), trainer)
    want, want_host, want_epoch = epoch_plan_counts(
        per_train, per_val, divmod(min(N_TRAIN_X, N_TRAIN_Y), TRAIN_BATCH),
        divmod(N_VAL, TRAIN_BATCH))
    print(f"1 epoch: {train_steps} train steps (the last a zip tail of "
          f"{N_TRAIN_X - (train_steps - 1) * TRAIN_BATCH} X and {TRAIN_BATCH} Y rows) and "
          f"{val_steps} val steps; per train step {per_train}, per val step {per_val}")

    def fit():
        with mock.patch.object(kernels.InstanceNormFunction, "backward",
                               staticmethod(counted_backward)):
            return (*trainer.fit(train_x, train_y, val_x, val_y, test, tmp,
                                 checkpoint_manager=mgr), mgr)

    launches, peak = check_fit(trainer, lambda: CycleGANTrainer(cfg), fit, want, want_host,
                               want_epoch, train_steps, floor)
    # the host traces the backward of a step it runs eagerly or captures; a
    # replay runs the captured K2 launches without calling it
    print(f"InstanceNormFunction.backward calls {bwd_calls[0]}, expected "
          f"{want_host['instance_norm_bwd']}")
    if bwd_calls[0] != want_host["instance_norm_bwd"]:
        raise AssertionError("K2 calls differ from the norm backwards")

    # one step from the fitted state, kernel path vs plain path
    u8x = torch.from_numpy(train_x[:TRAIN_BATCH]).to("cuda")
    u8y = torch.from_numpy(train_y[:TRAIN_BATCH]).to("cuda")
    gx, gy = (torch.Generator(device="cuda").manual_seed(SEED + i) for i in (4, 5))
    x = single_jitter_batch(u8x, gx, img_size=IMG_SIZE, dtype=torch.bfloat16)
    y = single_jitter_batch(u8y, gy, img_size=IMG_SIZE, dtype=torch.bfloat16)
    trainer32 = CycleGANTrainer(parse_cyclegan(argv[:-1] + ["fp32"]))
    trainer32.load_state(trainer.state())
    check_step_paths(trainer, trainer32, x, y, lambda t: [
        t._draws(SEED, 0, 0, 0, k) for k in range(len(t.passes(TRAIN_BATCH, TRAIN_BATCH)))])
    check_forms(trainer, trainer32, x, y)
    del trainer32

    phase(f"8. CycleGAN training numbers: train step at {IMG_SIZE}², bf16, batch {TRAIN_BATCH}, "
          "uint8 batch resident on the card")
    # what the eager step runs: draws, jitter, gradients, four Adam updates
    eager_step = lambda: trainer._step(u8x, u8y, 0, 0, 0)
    phase8 = step_numbers(eager_step, TRAIN_BATCH, peak, "image-pairs")
    trace_dgrad(eager_step)

    phase(f"8b. CycleGAN graph step: the epoch runner's CUDA graph against the eager step, "
          f"batch {TRAIN_BATCH}")
    caches = tuple(torch.from_numpy(a).to("cuda") for a in (train_x, train_y))
    graph = check_graph_step(trainer, lambda: CycleGANTrainer(cfg), caches, TRAIN_BATCH)
    graph_numbers(graph, eager_step, caches, TRAIN_BATCH, phase8, "image-pairs")
    del graph, caches, trainer

    phase(f"8c. CycleGAN graph step in both forms, {IMG_SIZE}², batch "
          f"{', '.join(map(str, FORM_BATCHES[IMG_SIZE]))}")
    form_sweep(tmp, IMG_SIZE, TRAIN_BATCH, smi)

    phase(f"8d. CycleGAN fit at {IMG_SIZE}², batch {REF_BATCH}, in the batched form")
    if not cyclegan_batched(IMG_SIZE, REF_BATCH):
        raise AssertionError(f"batch {REF_BATCH} does not run the batched form at {IMG_SIZE}²")
    cfg4 = parse_cyclegan(argv[:argv.index("--batch-size") + 1] + [str(REF_BATCH)]
                          + argv[argv.index("--batch-size") + 2:])
    floor = reset_memory()
    trainer = CycleGANTrainer(cfg4)
    offsets_from_seed(trainer)
    plan = (divmod(min(N_TRAIN_X, N_TRAIN_Y), REF_BATCH), divmod(N_VAL, REF_BATCH))
    want, want_host, want_epoch = epoch_plan_counts(
        *with_adam(*cyclegan_launches(IMG_SIZE, True), trainer), *plan)
    mgr4 = CheckpointManager(os.path.join(tmp, "batch_4_checkpoints"), max_to_keep=1)
    print(f"1 epoch: {plan[0][0] + (plan[0][1] > 0)} train steps and "
          f"{plan[1][0] + (plan[1][1] > 0)} val steps in the batched form")
    counted, _ = check_fit(trainer, lambda: CycleGANTrainer(cfg4), lambda: (*trainer.fit(
        train_x, train_y, val_x, val_y, test, tmp, checkpoint_manager=mgr4), mgr4), want,
        want_host, want_epoch, plan[0][0] + (plan[0][1] > 0), floor)
    for name, n in counted.items():
        launches[name] += n
    return launches


def seeded_pix2pix(cfg) -> Pix2PixTrainer:
    """Phase 9's model: the trainer's seeded init, with seeded batch-norm betas."""
    trainer = Pix2PixTrainer(cfg)
    offsets_from_seed(trainer)
    return trainer


def run_pix2pix_predict(tmp: str) -> dict:
    """Phase 9. Returns the kernel launch counts of the main-path run."""
    data, out, weights = (os.path.join(tmp, d) for d in ("data", "out", "run"))
    argv = ["--data", data, "--output", out, "--predict", "--weights", weights,
            "--img-size", str(IMG_SIZE), "--channels", "1", "--dtype", "bf16"]
    cfg = parse_pix2pix(argv)
    seeded = seeded_pix2pix(cfg)
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
    floor = reset_memory()
    trainer = Pix2PixTrainer(cfg)
    offsets_from_seed(trainer)
    rng = np.random.default_rng(SEED + 8)
    pad = IMG_SIZE + 30
    train = rng.integers(0, 256, (N_P2P_TRAIN, 2, pad, pad, 1), dtype=np.uint8)
    val = rng.integers(0, 256, (N_P2P_VAL, 2, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8)
    test = rng.integers(0, 256, (1, 2, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8)
    mgr = CheckpointManager(os.path.join(tmp, "training_checkpoints"), max_to_keep=1)
    train_steps, val_steps = -(-N_P2P_TRAIN // P2P_BATCH), -(-N_P2P_VAL // P2P_BATCH)
    per_step = pix2pix_launches(IMG_SIZE, P2P_BATCH, True)
    want, want_host, want_epoch = epoch_plan_counts(
        *with_adam(per_step, per_step, trainer), divmod(N_P2P_TRAIN, P2P_BATCH),
        divmod(N_P2P_VAL, P2P_BATCH))
    print(f"1 epoch: {train_steps} train steps (the last of {N_P2P_TRAIN % P2P_BATCH} rows) and "
          f"{val_steps} val steps (the last of {N_P2P_VAL % P2P_BATCH} rows), "
          f"{PIX2PIX_STEMS_PER_STEP} S per step, no K1 or K2 (batch statistics)")

    def fit():
        return (*trainer.fit(train, val, test, tmp, checkpoint_manager=mgr), mgr)

    launches, peak = check_fit(trainer, lambda: Pix2PixTrainer(cfg), fit, want, want_host,
                               want_epoch, train_steps, floor)

    u8 = torch.from_numpy(train[:P2P_BATCH]).to("cuda")
    x, y = paired_jitter_batch(u8, torch.Generator(device="cuda").manual_seed(SEED + 4),
                               img_size=IMG_SIZE, dtype=torch.bfloat16)
    trainer32 = Pix2PixTrainer(parse_pix2pix(argv[:-1] + ["fp32"]))
    trainer32.load_state(trainer.state())
    check_step_paths(trainer, trainer32, x, y, lambda t: t._draws(SEED, 0, 0, 0, 0))
    del trainer32

    phase(f"11. Pix2Pix training numbers: train step at {IMG_SIZE}², bf16, batch {P2P_BATCH}, "
          "uint8 batch resident on the card")
    # what the eager step runs: draws, paired jitter, gradients, two Adam updates
    eager_step = lambda: trainer._step(u8, 0, 0, 0)
    phase8 = step_numbers(eager_step, P2P_BATCH, peak, "image-pairs")

    phase(f"11b. Pix2Pix graph step: the epoch runner's CUDA graph against the eager step, "
          f"batch {P2P_BATCH}")
    caches = (torch.from_numpy(train).to("cuda"),)
    graph = check_graph_step(trainer, lambda: Pix2PixTrainer(cfg), caches, P2P_BATCH)
    graph_numbers(graph, eager_step, caches, P2P_BATCH, phase8, "image-pairs")
    del graph, caches, trainer
    bench_batch_epoch(tmp)
    return launches


def bench_batch_epoch(tmp: str) -> None:
    """Not a gate: one epoch of GRAPH_STEPS full steps of Pix2Pix at
    bench.py's per-chip batch, after the epoch that captured its graph, with
    its pairs/s and the peak device memory of both epochs."""
    argv = ["--data", tmp, "--output", tmp, "--train", "--epochs", "2",
            "--img-size", str(IMG_SIZE), "--batch-size", str(P2P_BENCH_BATCH), "--dtype", "bf16"]
    trainer = Pix2PixTrainer(parse_pix2pix(argv))
    offsets_from_seed(trainer)
    pad = IMG_SIZE + 30
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cache = torch.randint(0, 256, (GRAPH_STEPS * P2P_BENCH_BATCH, 2, pad, pad, 1),
                          generator=g, device="cuda", dtype=torch.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = trainer.run_epoch(cache, 0, training=True)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = trainer.run_epoch(cache, 1, training=True)
    epoch_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (np.isfinite(first).all() and np.isfinite(second).all()):
        raise AssertionError("a loss is not finite")
    print(f"Pix2Pix at batch {P2P_BENCH_BATCH} (bench.py's per-chip batch), {IMG_SIZE}², bf16: "
          f"a graph epoch of {GRAPH_STEPS} steps took {epoch_s * 1e3:.1f} ms, "
          f"{GRAPH_STEPS * P2P_BENCH_BATCH / epoch_s:.2f} image-pairs/s "
          f"({epoch_s / GRAPH_STEPS * 1e3:.3f} ms per step; the epoch before, with the warm-up "
          f"step and the capture, {capture_s:.2f} s); runner {trainer.epoch_counts}; peak device "
          f"memory {peak:.2f} GiB")


def extractor_rate(model, x: torch.Tensor, batch: int, tf32: bool) -> float:
    """Images/s of the extractor's forward on ``batch`` resident 299² images
    (median of 5 eager calls, CUDA events), TF32 on or off."""
    xs = x[:batch]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            ms = median_ms(lambda: model(xs), reps=5)
    finally:
        tf32_off()
    return batch / ms * 1e3


def inception_flops(model) -> float:
    """Operations of the convs of one 299² image: 2 per multiply-add."""
    flops = []
    hooks = [b.register_forward_hook(lambda m, inp, out: flops.append(
        2.0 * out.numel() * m.w[0].numel())) for b in model.blocks]
    with torch.no_grad():
        model(torch.zeros((1, inception.SIZE, inception.SIZE, 3), device="cuda"))
    for h in hooks:
        h.remove()
    return sum(flops)


def run_quality(tmp: str, smi: str) -> dict:
    """Phase 12. Returns the kernel launch counts of the main-path run."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("phase 12 writes PNGs and needs Pillow, which this machine "
                           "lacks") from e
    npz = os.path.join(tmp, "iv3.npz")
    params = inception.random_params(SEED)
    inception.save_params(params, npz)
    cpu_model = inception.load_params(npz)
    model = inception.load_params(npz).to("cuda")
    for block, p in zip(cpu_model.blocks, params):
        if not torch.equal(block.w, torch.from_numpy(p["w"].transpose(3, 2, 0, 1).copy())):
            raise AssertionError("load_params changed the weights")
    print(f"InceptionV3: {len(model.blocks)} conv+BN blocks, "
          f"{sum(t.numel() for t in model.buffers()) / 1e6:.2f} M weights, seeded random, "
          f"through {os.path.basename(npz)}")

    x8 = np.random.default_rng(SEED + 11).uniform(
        -1, 1, (8, inception.SIZE, inception.SIZE, 3)).astype(np.float32)
    want = inception.extract_features(cpu_model, x8)
    got = inception.extract_features(model, x8)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            tf32 = model(torch.from_numpy(x8).to("cuda")).cpu().numpy()
    finally:
        tf32_off()
    scale = float(np.abs(want).max())
    err, err_tf32 = float(np.abs(got - want).max()), float(np.abs(tf32 - want).max())
    print(f"pool3 features of 8 images at 299², card (TF32 off) vs CPU: max_abs_err {err:.3e} "
          f"of a largest feature {scale:.3f} (tol {FEATURE_TOL:g} of it); with TF32 on, not a "
          f"gate: {err_tf32:.3e}")
    if got.shape != (8, 2048) or not np.isfinite(got).all() or err > FEATURE_TOL * scale:
        raise AssertionError("the card's Inception features disagree with the CPU's")

    argv = ["--data", tmp, "--output", tmp, "--predict", "--weights", tmp,
            "--img-size", str(IMG_SIZE), "--channels", "1", "--dtype", "bf16"]
    trainer = seeded_pix2pix(parse_pix2pix(argv))
    u8 = np.random.default_rng(SEED + 12).integers(0, 256, (N_QUALITY, IMG_SIZE, IMG_SIZE, 1),
                                                   dtype=np.uint8)
    kernels.reset_launches()
    pred, launches = device_launches(lambda: trainer.generate_batched(u8, chunk=BATCH))
    host = dict(kernels.LAUNCHES)
    passes = N_QUALITY // BATCH
    expect = {"instance_norm_fwd": 14 * passes, "instance_norm_bwd": 0, "stem_conv": passes,
              "adam_update": 0}
    print(f"Pix2Pix generator (phase 9's seeded weights, bf16) on {N_QUALITY} images: launches "
          f"counted on the card {launches}, by the wrappers {host}, expected {expect}")
    if launches != expect or host != expect:
        raise AssertionError("launch counts differ from the generator's structure")
    del trainer
    targets = np.random.default_rng(SEED + 13).integers(
        0, 256, (N_QUALITY, IMG_SIZE, IMG_SIZE), dtype=np.uint8)
    gen_dir, tar_dir = os.path.join(tmp, "generated"), os.path.join(tmp, "target")
    for d in (gen_dir, tar_dir):
        os.makedirs(d)
    for i in range(N_QUALITY):
        gen_u8 = np.clip((pred[i, :, :, 0] + 1.0) * 127.5, 0, 255).astype(np.uint8)
        Image.fromarray(gen_u8).save(os.path.join(gen_dir, f"img{i}.png"))
        Image.fromarray(targets[i]).save(os.path.join(tar_dir, f"img{i}.png"))

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = eval_quality.main(["--generated", gen_dir, "--target", tar_dir,
                                "--img-size", str(IMG_SIZE), "--fid-weights", npz])
    tool_s = time.perf_counter() - t0
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"eval_quality on the card, {N_QUALITY} generated vs {N_QUALITY} target PNGs at "
          f"{IMG_SIZE}² ({tool_s:.2f} s): {json.dumps(report)}")
    keys = {"n_images", "l1", "ssim", "psnr_db", "frechet_proxy", "fid"}
    if rc != 0 or set(report) != keys or report["n_images"] != N_QUALITY or not all(
            math.isfinite(report[k]) for k in keys):
        raise AssertionError("the quality report is incomplete or not finite")

    phase(f"12b. quality numbers: the Inception extractor at 299², fp32 ({smi})")
    x = torch.rand((256, inception.SIZE, inception.SIZE, 3),
                   generator=torch.Generator(device="cuda").manual_seed(SEED + 14),
                   device="cuda") * 2 - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = {(b, tf): extractor_rate(model, x, b, tf) for tf in (False, True) for b in (64, 256)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = inception_flops(model)
    for (b, tf), r in rates.items():
        print(f"extractor forward at batch {b}, TF32 {'on (not a gate)' if tf else 'off'}: "
              f"{r:.1f} images/s, {r * flops / 1e12:.2f} TFLOP/s in the convs ({smi})")
    print(f"peak device memory of the extractor runs at batch 256, input included: "
          f"{peak:.2f} GiB ({smi})")
    print(f"device time of one forward at batch 64, TF32 off ({flops / 1e9:.2f} GFLOP of "
          f"convs an image; fp32 peak {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s):")
    with torch.no_grad():
        busy_us, _ = profile_device(lambda: model(x[:64]), calls=2)
    print(f"  the card idle {1 - busy_us / 1e3 / (64 / rates[(64, False)] * 1e3):.1%} of the "
          f"median forward ({smi})")
    feats = [inception.extract_features(model, x[lo:lo + N_QUALITY])
             for lo in (0, N_QUALITY)]
    t0 = time.perf_counter()
    fid = quality.frechet_distance(*feats)
    sqrtm_s = time.perf_counter() - t0
    print(f"the host's Fréchet distance of two sets of {N_QUALITY} 2048-d features (scipy "
          f"sqrtm in float64): {sqrtm_s:.2f} s, FID {fid:.4f} ({smi})")
    return launches


def write_noise_pngs(directory: str, n: int, shape: tuple, seed: int) -> list[str]:
    """``n`` grayscale PNGs of seeded uniform noise, drawn as phase 12 draws
    its images. Noise does not compress, so decoding one inflates every byte
    of it: the worst case for a PNG decoder, which the measured rates keep."""
    from PIL import Image

    pixels = np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)
    os.makedirs(directory)
    paths = [os.path.join(directory, f"{i:04d}.png") for i in range(n)]
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda i: Image.fromarray(pixels[i]).save(paths[i]), range(n)))
    return paths


def seconds(fn, reps: int = 3) -> float:
    """The median wall seconds of ``reps`` calls of ``fn()``."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append(time.perf_counter() - t0)
    return float(np.median(runs))


def first_batch_ms(cache) -> float:
    """The median ms (of 3 epochs) until an epoch's first batch: the
    producer's start and one batch's decode, the part of a streamed epoch
    that nothing overlaps. Closing the epoch is not timed."""
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        epoch = cache.epoch()
        next(epoch)
        runs.append(time.perf_counter() - t0)
        epoch.close()
    return float(np.median(runs)) * 1e3


def idat(path: str) -> bytes:
    """The zlib stream of a PNG: its IDAT chunks' data, joined."""
    with open(path, "rb") as f:
        data = f.read()
    pos, out = 8, []
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            out.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return b"".join(out)


def twin(rows, workers: int):
    """``rows`` on the PIL twin (every file through its per-file sample) with
    a pool of ``workers`` threads."""
    return pipeline.Rows(rows.sample, rows.shape, workers=workers)


def native_threads(rows, threads: int):
    """``rows`` on the native decoder with ``threads`` threads a call."""
    return pipeline.Rows(rows.sample, rows.shape, rows.native_batch, threads=threads)


def decode_numbers(what: str, paths: list, rows, val_rows, batch: int, split, smi: str) -> float:
    """13a for one kind of file. The gate: the native rows of every file
    equal the PIL twin's bit for bit, in the train and the val form. Then,
    the files in the page cache: files/s of the native decoder at 1 thread,
    at all cores less one and at all cores, and of the PIL twin at 1 worker
    and at the FileCache's 16; single-threaded ms per file of PIL's decode
    alone, of the numpy resizes alone (``split(image)``: the split and
    resizes of one decoded file), of the native decode with its resizes and
    of zlib's inflate of the file's IDAT data alone (into a buffer of the
    rows' size, as the decoder inflates); ms to a FileCache epoch's first
    batch of ``batch``, native and twin. The single-threaded readings take
    the first ``ONE_THREAD_FILES`` files. Returns the native files/s at all
    cores."""
    for form, r in (("train", rows), ("val", val_rows)):
        got, want = r(paths), twin(r, pipeline.DECODE_WORKERS)(paths)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{what}: the native {form} rows differ from the PIL twin's")
    print(f"{what}: native rows equal the PIL twin's bit for bit over all {len(paths)} files, "
          f"train {rows.shape} and val {val_rows.shape}")
    cores = native.default_threads()
    rates = {}
    few = paths[:ONE_THREAD_FILES]
    for label, r, files in (("native, 1 thread", native_threads(rows, 1), few),
                            (f"native, {cores - 1} threads", native_threads(rows, cores - 1), paths),
                            (f"native, {cores} threads (the default)", rows, paths),
                            ("PIL twin, 1 worker", twin(rows, 1), few),
                            (f"PIL twin, {pipeline.DECODE_WORKERS} workers",
                             twin(rows, pipeline.DECODE_WORKERS), paths)):
        rates[label] = len(files) / seconds(lambda: r(files))
        print(f"{what}: {label}: {rates[label]:.1f} files/s over {len(files)} files")
    images = [pipeline.decode_image(p, rows.shape[-1]) for p in few]
    streams = [idat(p) for p in few]
    raw = images[0].shape[0] * (images[0].shape[1] + 1)   # 8-bit gray rows and their filter bytes
    pil_ms = seconds(lambda: [pipeline.decode_image(p, rows.shape[-1]) for p in few]) * 1e3
    resize_ms = seconds(lambda: [split(im) for im in images]) * 1e3
    inflate_ms = seconds(lambda: [zlib.decompress(z, bufsize=raw) for z in streams]) * 1e3
    n = len(few)
    print(f"{what}, one thread, ms per file: PIL decode {pil_ms / n:.3f}, numpy split and resizes "
          f"{resize_ms / n:.3f} (together {(pil_ms + resize_ms) / n:.3f}); native decode and "
          f"resizes {1e3 / rates['native, 1 thread']:.3f}, of which zlib's inflate alone "
          f"(zlib.decompress of the IDAT data into the rows' size, zlib {zlib.ZLIB_RUNTIME_VERSION}) "
          f"{inflate_ms / n:.3f}")
    pil_16 = rates[f"PIL twin, {pipeline.DECODE_WORKERS} workers"]
    print(f"{what}: PIL twin at {pipeline.DECODE_WORKERS} workers {pil_16:.1f} files/s against "
          f"{cores} cores x its 1-worker rate = {cores * rates['PIL twin, 1 worker']:.1f}; "
          f"native at {cores} threads {rates[f'native, {cores} threads (the default)'] / pil_16:.2f}x "
          "the PIL twin at 16")
    first = {label: first_batch_ms(FileCache(paths, r, batch))
             for label, r in (("native", rows), ("PIL twin", twin(rows, pipeline.DECODE_WORKERS)))}
    print(f"{what}: first batch of {batch} after {first['native']:.1f} ms native, "
          f"{first['PIL twin']:.1f} ms PIL twin; {cores} cores usable, os.cpu_count() "
          f"{os.cpu_count()} ({smi})")
    return rates[f"native, {cores} threads (the default)"]


def recorded_epochs(trainer) -> list:
    """Every (steps, K) loss array ``trainer.run_epoch`` returns from now on."""
    seen, real = [], trainer.run_epoch

    def run_epoch(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    trainer.run_epoch = run_epoch
    return seen


def compare_epochs(first, second, got: list, want: list, what: str) -> None:
    """The epochs' losses (``got`` of ``first``, ``want`` of ``second``),
    every network's parameters and buffers and Adam's state of two trainers
    that ran them from the same start, bit for bit. Streamed against
    resident epochs (phase 13), and remat against remat-free epochs (14c,
    14d), run the same kernels on the same bytes in the same order, so any
    difference is a fault: a step that read a stale or the next batch from
    the stream's buffers, or a recomputed block that read another input or
    dropout mask than its forward."""
    if [g.shape for g in got] != [w.shape for w in want]:
        raise AssertionError(f"{what}: the epochs ran other steps")
    pairs = [(f"{k}.{name}", a, b) for k in first.nets
             for (name, a), b in zip(first.nets[k].state_dict().items(),
                                     second.nets[k].state_dict().values())]
    for k in first.opts:
        sa, sb = first.opts[k].state_dict()["state"], second.opts[k].state_dict()["state"]
        pairs += [(f"{k} Adam {i}.{n}", v, sb[i][n]) for i in sa for n, v in sa[i].items()]
    differ = [name for name, a, b in pairs if not torch.equal(a, b)]
    loss_diff = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
    print(f"{what} (train, val): steps {[len(g) for g in got]}; losses max |difference| "
          f"{loss_diff:.3e}; {len(pairs) - len(differ)} of {len(pairs)} parameter, buffer and "
          f"Adam tensors equal bit for bit")
    if not all(np.array_equal(g, w) for g, w in zip(got, want)) or differ:
        raise AssertionError(f"{what}: the epochs differ: {differ[:8]}")


STREAM_ROUNDS = 3   # rounds of timed train epochs per path in 13b and 13c, each in turns and back


def no_prefetch(fn):
    """``fn`` with ``prefetch_iter`` as a passthrough (``GAN_TPU_PREFETCH_DEPTH=0``):
    the streamed epoch's host batches are assembled on the main thread."""
    def run():
        with mock.patch.dict(os.environ, {"GAN_TPU_PREFETCH_DEPTH": "0"}):
            return fn()
    return run


def streamed_numbers(paths: dict, baselines: dict, steps: int, rows: int, h2d_bytes: int,
                     decode: str, smi: str, once: dict) -> None:
    """Train epochs (all replays and the eager tail) of each path and each
    baseline, timed to the card's synchronisation in ``STREAM_ROUNDS``
    rounds of them all in turns and back (the paths of ``once`` in the
    first round only, there and back): pairs/s at the median, every reading
    and its spread; then each path and each of ``once`` (not the baselines,
    which run the same device work) profiled once: device time per step and
    the card's idle share, beside the decode rates (``decode``). The files are read from
    the page cache (written just before): disk reads are not measured."""
    every = {**paths, **baselines, **once}
    runs = {label: [] for label in every}
    for r, order in enumerate((list(every), list(every)[::-1]) * STREAM_ROUNDS):
        for label in order:
            if label in once and r >= 2:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            every[label]()
            torch.cuda.synchronize()
            runs[label].append(time.perf_counter() - t0)
    for label, fn in every.items():
        epoch_s = float(np.median(runs[label]))
        spread = (max(runs[label]) - min(runs[label])) / epoch_s
        device = ""
        if label not in baselines:
            print(f"train epoch, {label}: device time per step:")
            busy_us, _ = profile_device(fn, calls=1, steps=steps)
            device = (f"; device {busy_us / 1e3:.3f} ms per step, so the card is idle "
                      f"{1 - busy_us / 1e3 * steps / (epoch_s * 1e3):.1%}")
        print(f"train epoch, {label}: median {epoch_s * 1e3:.1f} ms of {len(runs[label])} (runs "
              f"{[round(r * 1e3, 1) for r in runs[label]]}, spread {spread:.1%}), "
              f"{rows / epoch_s:.2f} image-pairs/s ({rows / max(runs[label]):.2f}-"
              f"{rows / min(runs[label]):.2f}), {epoch_s / steps * 1e3:.3f} ms per step"
              f"{device} ({smi})")
    print(f"host-to-device bytes per streamed step {h2d_bytes:,} (pinned, on the compute "
          f"stream); native decode {decode} with {native.default_threads()} threads")


def check_streamed_predict(trainer, cache, array, names, tmp: str, per_pass: dict) -> dict:
    """``predict`` over a FileCache against ``predict`` over the decoded
    array: the same per-image outputs and raw PNG bytes, S and K1 launches
    per generator pass of 16, by the wrappers and on the card. matplotlib is
    absent on the card's machine, so the grids are not drawn
    (``save_image_grid`` is stubbed): the raw PNGs are written
    (``write_raw``). Then the streamed predict's images/s, decode and PNG
    writing included, on the native decoder and, in turns, on the PIL twin.
    Returns the launches."""
    preds = {}

    def run(source, label):
        out = os.path.join(tmp, label)
        preds[label] = []
        real_write = base.write_raw
        with mock.patch.object(base, "save_image_grid", lambda *a, **kw: None), \
                mock.patch.object(base, "write_raw", lambda p, *a: (
                    preds[label].append(p), real_write(p, *a))):
            trainer.predict(source, out, raw=True, raw_names=names)
        return out

    kernels.reset_launches()
    streamed_dir, launches = device_launches(lambda: run(cache, "streamed"))
    host = dict(kernels.LAUNCHES)
    resident_dir = run(array, "resident")
    got, ref = np.concatenate(preds["streamed"]), np.concatenate(preds["resident"])
    raw = sorted(os.listdir(os.path.join(streamed_dir, "prediction_images_raw")))
    png = lambda root, name: open(os.path.join(root, "prediction_images_raw", name), "rb").read()
    same_png = raw == sorted(os.listdir(os.path.join(resident_dir, "prediction_images_raw"))) \
        and all(png(streamed_dir, n) == png(resident_dir, n) for n in raw)
    if got.shape != ref.shape or len(raw) != len(names) or not np.isfinite(got).all():
        raise AssertionError("the streamed predict wrote other outputs")
    print(f"outputs {got.shape}, streamed vs resident predict: max_abs_err "
          f"{float(np.abs(got - ref).max()):.3e}; {len(raw)} raw PNGs "
          f"{'byte-equal' if same_png else 'differ'}")
    if not np.array_equal(got, ref) or not same_png:   # the same kernels on the same bytes
        raise AssertionError("the streamed predict differs from the resident predict")
    passes = -(-len(names) // BATCH)
    want = {name: n * passes for name, n in per_pass.items()}
    print(f"predict over {len(names)} files: launches counted on the card {launches}, by the "
          f"wrappers {host}, expected {want}")
    if launches != want or host != want:
        raise AssertionError("launch counts differ from the generator's structure")
    pil = FileCache(cache.paths, twin(cache.rows, pipeline.DECODE_WORKERS), cache.batch_size)
    runs = {"native": [], "PIL twin": []}
    for i in range(3):
        for label, source in (("native", cache), ("PIL twin", pil)):
            t0 = time.perf_counter()
            run(source, f"timed{i}")
            runs[label].append(time.perf_counter() - t0)
    for label, r in runs.items():
        e2e = float(np.median(r))
        print(f"streamed predict of {len(names)} PNGs, {label}, with the raw PNGs written: "
              f"{e2e * 1e3:.1f} ms (runs {[round(x * 1e3, 1) for x in r]}), "
              f"{len(names) / e2e:.2f} images/s")
    return launches


def run_host_data(tmp: str, smi: str) -> dict:
    """Phase 13. Returns the kernel launch counts of the main-path runs."""
    pad = IMG_SIZE + 30
    pairs = write_noise_pngs(os.path.join(tmp, "pairs"), N_P2P_TRAIN, (IMG_SIZE, 2 * IMG_SIZE),
                             SEED + 15)
    xs = write_noise_pngs(os.path.join(tmp, "x"), N_TRAIN_X, (IMG_SIZE, IMG_SIZE), SEED + 16)
    ys = write_noise_pngs(os.path.join(tmp, "y"), N_TRAIN_Y, (IMG_SIZE, IMG_SIZE), SEED + 17)
    ref_pairs = write_noise_pngs(os.path.join(tmp, "ref_pairs"), N_P2P_TRAIN, REF_PAIR, SEED + 18)
    ref_xs = write_noise_pngs(os.path.join(tmp, "ref_x"), N_TRAIN_X, REF_SINGLE, SEED + 19)
    ref_ys = write_noise_pngs(os.path.join(tmp, "ref_y"), N_TRAIN_Y, REF_SINGLE, SEED + 20)
    mb = lambda files: sum(os.path.getsize(p) for p in files) / 1e6
    print(f"{len(pairs)} Pix2Pix pairs of {2 * IMG_SIZE}x{IMG_SIZE} and {len(xs)} X and {len(ys)} "
          f"Y CycleGAN images of {IMG_SIZE}², uniform noise, {mb(pairs + xs + ys):.1f} MB of PNG; "
          f"at the reference corpus's sizes as many pairs of {REF_PAIR[1]}x{REF_PAIR[0]} and "
          f"singles of {REF_SINGLE[1]}x{REF_SINGLE[0]}, {mb(ref_pairs + ref_xs + ref_ys):.1f} MB")

    phase(f"13a. decode on the card's host ({os.cpu_count()} cores): the native decoder against "
          "the PIL twin")
    p2p = dict(img_size=IMG_SIZE, channels=1, orient="left")
    made = []   # every Rows of the phase, for their JPEG counts

    def rows(kind: str, train: bool, **kw):
        make = pipeline.pix2pix_rows if kind == "pix2pix" else pipeline.cyclegan_rows
        made.append(make(train=train, **(p2p if kind == "pix2pix" else
                                         dict(img_size=IMG_SIZE, channels=1)), **kw))
        return made[-1]

    p2p_rows, cg_rows = rows("pix2pix", True), rows("cyclegan", True)
    split_pair = lambda im: [pipeline.resize_nearest_np(h, pad, pad)
                             for h in pipeline.split_pair(im, "left")]
    resize_twice = lambda im: pipeline.resize_nearest_np(
        pipeline.resize_nearest_np(im, IMG_SIZE, IMG_SIZE), pad, pad)
    p2p_rate, ref_p2p_rate = (decode_numbers(
        f"Pix2Pix pairs ({w}x{h} -> 2 x {pad}²)", files, p2p_rows, rows("pix2pix", False),
        P2P_BATCH, split_pair, smi)
        for files, (h, w) in ((pairs, (IMG_SIZE, 2 * IMG_SIZE)), (ref_pairs, REF_PAIR)))
    cg_rate, ref_cg_rate = (decode_numbers(
        f"CycleGAN ({w}x{h} -> {IMG_SIZE}² -> {pad}²)", files, cg_rows, rows("cyclegan", False),
        TRAIN_BATCH, resize_twice, smi)
        for files, (h, w) in ((xs + ys, (IMG_SIZE, IMG_SIZE)), (ref_xs + ref_ys, REF_SINGLE)))
    p2p_train = FileCache(pairs, p2p_rows, P2P_BATCH)
    cg_x, cg_y = FileCache(xs, cg_rows, TRAIN_BATCH), FileCache(ys, cg_rows, TRAIN_BATCH)
    train_u8 = pipeline.build_pix2pix_cache(pairs, train=True, **p2p)
    x_u8, y_u8 = (pipeline.build_cyclegan_cache(p, img_size=IMG_SIZE, channels=1, train=True)
                  for p in (xs, ys))
    cores = native.default_threads()
    ref = f"{REF_PAIR[1]}x{REF_PAIR[0]}"

    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    phase(f"13b. Pix2Pix fit from FileCaches (--host-cache off's path), batch {P2P_BATCH}, "
          "against the resident epoch")
    argv = ["--data", tmp, "--output", tmp, "--train", "--epochs", "1", "--img-size",
            str(IMG_SIZE), "--batch-size", str(P2P_BATCH), "--dtype", "bf16", "--host-cache", "off"]
    cfg = parse_pix2pix(argv)
    streamed, resident = seeded_pix2pix(cfg), seeded_pix2pix(cfg)
    val_fc = FileCache(pairs[:N_P2P_VAL], rows("pix2pix", False), P2P_BATCH)
    val_u8 = pipeline.build_pix2pix_cache(pairs[:N_P2P_VAL], train=False, **p2p)
    test = val_u8[:1]
    got = recorded_epochs(streamed)
    per_step = pix2pix_launches(IMG_SIZE, P2P_BATCH, True)
    want, want_host, want_epoch = epoch_plan_counts(
        *with_adam(per_step, per_step, streamed), divmod(N_P2P_TRAIN, P2P_BATCH),
        divmod(N_P2P_VAL, P2P_BATCH))
    kernels.reset_launches()
    _, counted = device_launches(lambda: streamed.fit(p2p_train, val_fc, test, tmp))
    host = dict(kernels.LAUNCHES)
    print(f"streamed fit: launches counted on the card {counted}, expected {want}; by the "
          f"wrappers {host}, expected {want_host}; runner steps {streamed.epoch_counts}, expected "
          f"{want_epoch}; stream buffers "
          f"{[tuple(b.shape) for s in streamed._streams.values() for b in s.buffers]}")
    if counted != want or host != want_host or streamed.epoch_counts != want_epoch:
        raise AssertionError("the streamed fit ran other launches or steps than derived")
    add(counted)
    train_dev, val_dev = (torch.from_numpy(a).to("cuda") for a in (train_u8, val_u8))
    want_losses = [resident.run_epoch(train_dev, 0, training=True),
                   resident.run_epoch(val_dev, 0, training=False)]
    compare_epochs(streamed, resident, got, want_losses, "streamed vs resident epochs")
    steps = -(-N_P2P_TRAIN // P2P_BATCH)
    from_host = lambda: streamed.run_epoch(train_u8, 1, training=True)
    from_files = lambda: streamed.run_epoch(p2p_train, 1, training=True)
    less_one = FileCache(pairs, rows("pix2pix", True, threads=cores - 1), P2P_BATCH)
    pil = FileCache(pairs, twin(p2p_rows, pipeline.DECODE_WORKERS), P2P_BATCH)
    ref_files = FileCache(ref_pairs, p2p_rows, P2P_BATCH)
    ref_pil = FileCache(ref_pairs, twin(p2p_rows, pipeline.DECODE_WORKERS), P2P_BATCH)
    streamed_numbers({"resident": lambda: resident.run_epoch(train_dev, 1, training=True),
                      "host memory": from_host, "files": from_files,
                      f"files of {ref}": lambda: streamed.run_epoch(ref_files, 1, training=True)},
                     {"host memory, no prefetch thread": no_prefetch(from_host),
                      "files, no prefetch thread": no_prefetch(from_files)},
                     steps, N_P2P_TRAIN, P2P_BATCH * 2 * pad * pad,
                     f"{p2p_rate:.1f} pair files/s of {2 * IMG_SIZE}x{IMG_SIZE}, "
                     f"{ref_p2p_rate:.1f} of {ref}", smi,
                     {f"files, native at {cores - 1} threads":
                          lambda: streamed.run_epoch(less_one, 1, training=True),
                      "files, PIL twin": lambda: streamed.run_epoch(pil, 1, training=True),
                      f"files of {ref}, PIL twin": lambda: streamed.run_epoch(ref_pil, 1,
                                                                              training=True)})
    if streamed.epoch_counts["captures"] != 2:
        raise AssertionError("the streamed runner was captured again")
    del streamed, resident, train_dev, val_dev

    phase(f"13c. CycleGAN fit from FileCaches, batch {TRAIN_BATCH}, against the resident epoch")
    argv = ["--input-images", tmp, "--target-images", tmp, "--output", tmp, "--train",
            "--epochs", "1", "--img-size", str(IMG_SIZE), "--batch-size", str(TRAIN_BATCH),
            "--dtype", "bf16", "--host-cache", "off"]
    cfg = parse_cyclegan(argv)
    streamed, resident = CycleGANTrainer(cfg), CycleGANTrainer(cfg)
    for t in (streamed, resident):
        offsets_from_seed(t)
    val = [FileCache(paths[:N_VAL], rows("cyclegan", False), TRAIN_BATCH) for paths in (xs, ys)]
    val_u8 = [pipeline.build_cyclegan_cache(paths[:N_VAL], img_size=IMG_SIZE, channels=1)
              for paths in (xs, ys)]
    got = recorded_epochs(streamed)
    want, want_host, want_epoch = epoch_plan_counts(
        *with_adam(*cyclegan_launches(IMG_SIZE, cyclegan_batched(IMG_SIZE, TRAIN_BATCH)), streamed),
        divmod(min(N_TRAIN_X, N_TRAIN_Y), TRAIN_BATCH),
        divmod(N_VAL, TRAIN_BATCH))
    kernels.reset_launches()
    _, counted = device_launches(lambda: streamed.fit(cg_x, cg_y, *val, val_u8[0][:1], tmp))
    host = dict(kernels.LAUNCHES)
    print(f"streamed fit: launches counted on the card {counted}, expected {want}; by the "
          f"wrappers {host}, expected {want_host}; runner steps {streamed.epoch_counts}, expected "
          f"{want_epoch}")
    if counted != want or host != want_host or streamed.epoch_counts != want_epoch:
        raise AssertionError("the streamed fit ran other launches or steps than derived")
    add(counted)
    train_dev = [torch.from_numpy(a).to("cuda") for a in (x_u8, y_u8)]
    val_dev = [torch.from_numpy(a).to("cuda") for a in val_u8]
    want_losses = [resident.run_epoch(*train_dev, 0, training=True),
                   resident.run_epoch(*val_dev, 0, training=False)]
    compare_epochs(streamed, resident, got, want_losses, "streamed vs resident epochs")
    steps = -(-min(N_TRAIN_X, N_TRAIN_Y) // TRAIN_BATCH)
    from_host = lambda: streamed.run_epoch(x_u8, y_u8, 1, training=True)
    from_files = lambda: streamed.run_epoch(cg_x, cg_y, 1, training=True)
    less_one = [FileCache(p, rows("cyclegan", True, threads=cores - 1), TRAIN_BATCH)
                for p in (xs, ys)]
    pil = [FileCache(p, twin(cg_rows, pipeline.DECODE_WORKERS), TRAIN_BATCH) for p in (xs, ys)]
    ref_files = [FileCache(p, cg_rows, TRAIN_BATCH) for p in (ref_xs, ref_ys)]
    ref_pil = [FileCache(p, twin(cg_rows, pipeline.DECODE_WORKERS), TRAIN_BATCH)
               for p in (ref_xs, ref_ys)]
    single = f"{REF_SINGLE[1]}x{REF_SINGLE[0]}"
    streamed_numbers({"resident": lambda: resident.run_epoch(*train_dev, 1, training=True),
                      "host memory": from_host, "files": from_files,
                      f"files of {single}": lambda: streamed.run_epoch(*ref_files, 1,
                                                                       training=True)},
                     {"host memory, no prefetch thread": no_prefetch(from_host),
                      "files, no prefetch thread": no_prefetch(from_files)},
                     steps, min(N_TRAIN_X, N_TRAIN_Y), 2 * TRAIN_BATCH * pad * pad,
                     f"{cg_rate:.1f} single files/s of {IMG_SIZE}², {ref_cg_rate:.1f} of {single}",
                     smi,
                     {f"files, native at {cores - 1} threads":
                          lambda: streamed.run_epoch(*less_one, 1, training=True),
                      "files, PIL twin": lambda: streamed.run_epoch(*pil, 1, training=True),
                      f"files of {single}, PIL twin": lambda: streamed.run_epoch(*ref_pil, 1,
                                                                                 training=True)})
    if streamed.epoch_counts["captures"] != 2:
        raise AssertionError("the streamed runner was captured again")
    del streamed, resident, train_dev, val_dev

    phase(f"13d. predict over {N_QUALITY} PNGs from a FileCache, both models ({smi})")
    per_pass = {"instance_norm_fwd": 14, "instance_norm_bwd": 0, "stem_conv": 1, "adam_update": 0}
    names = [os.path.basename(p) for p in pairs[:N_QUALITY]]
    trainer = seeded_pix2pix(parse_pix2pix(["--data", tmp, "--output", tmp, "--predict",
                                            "--weights", tmp, "--img-size", str(IMG_SIZE),
                                            "--dtype", "bf16", "--host-cache", "off"]))
    print("Pix2Pix (phase 9's seeded weights):")
    add(check_streamed_predict(
        trainer, FileCache(pairs[:N_QUALITY], rows("pix2pix", False), P2P_BATCH),
        pipeline.build_pix2pix_cache(pairs[:N_QUALITY], train=False, **p2p), names,
        os.path.join(tmp, "p2p_predict"), per_pass))
    trainer = CycleGANTrainer(parse_cyclegan(["--input-images", tmp, "--output", tmp, "--predict",
                                              "--weights", tmp, "--img-size", str(IMG_SIZE),
                                              "--dtype", "bf16", "--host-cache", "off"]))
    offsets_from_seed(trainer)
    print("CycleGAN (phase 5's seeded weights):")
    add(check_streamed_predict(
        trainer, FileCache(xs[:N_QUALITY], rows("cyclegan", False), TRAIN_BATCH),
        pipeline.build_cyclegan_cache(xs[:N_QUALITY], img_size=IMG_SIZE, channels=1),
        [os.path.basename(p) for p in xs[:N_QUALITY]], os.path.join(tmp, "cg_predict"),
        per_pass))
    jpegs = sum(r.jpeg_files for r in made)
    print(f"JPEG files sent to PIL in phase 13: {jpegs} (every file is a PNG); os.cpu_count() "
          f"{os.cpu_count()}; {smi}")
    if jpegs:
        raise AssertionError("a PNG went through PIL")
    return launches


def gan_config(kind: str, tmp: str, size: int, batch: int, remat: str, dtype: str = "bf16"):
    """The ``--train`` config of ``kind`` ('pix2pix' or 'cyclegan') for one epoch."""
    common = ["--output", tmp, "--train", "--epochs", "1", "--img-size", str(size),
              "--batch-size", str(batch), "--dtype", dtype, "--remat", remat]
    if kind == "pix2pix":
        return parse_pix2pix(["--data", tmp, *common])
    return parse_cyclegan(["--input-images", tmp, "--target-images", tmp, *common])


def seeded_trainer(kind: str, cfg):
    """The trainer's seeded init, with seeded norm offsets and betas."""
    trainer = (Pix2PixTrainer if kind == "pix2pix" else CycleGANTrainer)(cfg)
    offsets_from_seed(trainer)
    return trainer


def train_caches(kind: str, n: tuple, size: int, rng) -> tuple:
    """Seeded uint8 train caches at ``size`` + 30 (Pix2Pix: ``n[0]`` pairs;
    CycleGAN: ``n[0]`` X and ``n[1]`` Y images)."""
    pad = size + 30
    if kind == "pix2pix":
        return (rng.integers(0, 256, (n[0], 2, pad, pad, 1), dtype=np.uint8),)
    return tuple(rng.integers(0, 256, (m, pad, pad, 1), dtype=np.uint8) for m in n)


def check_norms_512() -> None:
    """14a: K1 and K2 against their plain versions at every norm site of
    the 512² paths, bf16 (both dtypes at the generator's 256²×64 site, the
    unstaged one): K1 and K2 at the training batch of 4 (ε 1e-5, CycleGAN)
    and at batch 1 (K1 at ε 1e-3, Pix2Pix's per-image batch norm), K1 at
    the predict chunk of 16 at the generator's sites; at the unstaged site,
    cudaOccupancyMaxActiveClusters and each kernel's per-block timeline;
    then the sums over one generator pass (K1, 14 sites) and one generator
    and one discriminator backward (K2, 17 sites) at batch 4, and over one
    generator pass at 16, in bf16."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 18)
    gen, disc = norm_sites(IMG_512, generator_depth(IMG_512)), disc_norm_sites(IMG_512)
    unstaged = (IMG_512 // 2, _DOWN_FILTERS[0])
    dtypes = lambda site: ((torch.float32, torch.bfloat16) if site == unstaged
                           else (torch.bfloat16,))
    k1, k2 = {}, {}
    print(L2_NOTE)
    print(K1_HEADER)
    for n, sites, eps in ((BATCH_512, gen + list(disc), norm.IN_EPS),
                          (1, gen + list(disc), norm.BN_EPS), (BATCH, gen, norm.IN_EPS)):
        for site in sorted(set(sites)):
            for dtype in dtypes(site):
                _, k1[(n, *site, dtype)] = k1_row(n, *site, dtype, None, eps, g)
    print(K2_HEADER)
    for n in (BATCH_512, 1):
        for site in sorted(set(gen) | set(disc)):
            for dtype in dtypes(site):
                _, k2[(n, *site, dtype)] = k2_row(n, *site, dtype, g)
    hw, c = unstaged
    for backward in (False, True):
        print_max_clusters(BATCH_512, hw, c, backward)
        x = (torch.randn(BATCH_512, hw, hw, c, device="cuda", generator=g) * 3.0 + 1.0).to(
            torch.bfloat16)
        scale = 1.0 + 0.02 * torch.randn(c, device="cuda", generator=g)
        plan = kernels.norm_plan(BATCH_512, hw * hw, c, torch.bfloat16, backward=backward)
        if backward:
            fn = lambda: kernels.instance_norm_backward(x, scale, torch.ones_like(x))
        else:
            fn = lambda: kernels.instance_norm(x, scale, torch.zeros_like(scale))
        print(f"{'K2' if backward else 'K1'} at {BATCH_512},{hw},{hw},{c} bf16, {plan}:")
        print_timeline(fn, plan, backward)
    for name, times, sites in (("K1", k1, gen), ("K2", k2, gen + list(disc))):
        t = [sum(times[(BATCH_512, *site, torch.bfloat16)][i] for site in sites) for i in range(4)]
        print(f"{name}, the {len(sites)} sites of one bf16 "
              f"{'generator pass' if name == 'K1' else 'generator and discriminator backward'} "
              f"at {IMG_512}², batch {BATCH_512}: kernel {t[0] * 1e3:.2f} us, plain "
              f"{t[1] * 1e3:.2f} us, library {t[2] * 1e3:.2f} us, bound {t[3] * 1e3:.2f} us; "
              f"share of bound {t[3] / t[0]:.1%}, kernel/library {t[0] / t[2]:.2f}")
    t16 = [sum(k1[(BATCH, *site, torch.bfloat16)][i] for site in gen) for i in range(4)]
    print(f"K1, the {len(gen)} sites of one bf16 generator pass at {IMG_512}², batch {BATCH}: "
          f"kernel {t16[0] * 1e3:.2f} us, plain {t16[1] * 1e3:.2f} us, library "
          f"{t16[2] * 1e3:.2f} us, bound {t16[3] * 1e3:.2f} us; share of bound "
          f"{t16[3] / t16[0]:.1%}, kernel/library {t16[0] / t16[2]:.2f}")


def graph_step_numbers(trainer, caches: tuple, batch: int) -> None:
    """The graph path's step time (an epoch of GRAPH_STEPS replays per call,
    timed there and back), image-pairs/s, and from a profile of one epoch
    the device time per step by kernel group and the card's idle share."""
    rows = tuple(torch.arange(GRAPH_STEPS * batch, device="cuda").remainder(c.shape[0]).view(
        GRAPH_STEPS, batch) for c in caches)
    paths = {"graph": (lambda: trainer._cached_epoch(caches, rows, 1, True), GRAPH_STEPS,
                       contextlib.nullcontext)}
    runs = timed_paths(paths, rounds=1, reps=3)
    busy_us, per_step, idle = profile_paths(paths, 1, runs, "train step")["graph"]
    ms = float(np.median(runs["graph"]))
    print(f"train step, graph path: median {ms:.3f} ms (runs {[round(r, 3) for r in runs['graph']]}"
          f"), {batch / ms * 1e3:.2f} image-pairs/s; device {busy_us / 1e3:.3f} ms, idle "
          f"{idle:.1%}, {per_step:.1f} kernels and copies per step")


def fit_512(kind: str, tmp: str, smi: str) -> dict:
    """14c (Pix2Pix) and 14d (CycleGAN): ``fit`` for one epoch at 512²,
    depth 8, bf16, batch 4 on seeded caches (full steps as graph replays, a
    partial tail, a val pass), remat off and then on, each from the seeded
    state on a trainer of its own (a runner captures its own setting's
    graph). Per setting: the launches counted on the card against the
    derivation (the recomputed stems and norms included), Adam's steps and
    the checkpoint round trip (``check_fit``), the peak memory of ``fit``.
    Then the two settings' losses, parameters and Adam states bit for bit,
    one step of the remat trainer through the kernels against the plain path
    (``STEP_TOL``), and each setting's graph step time and idle share.
    Returns the launches of both fits."""
    rng = np.random.default_rng(SEED + 19)
    if kind == "pix2pix":
        train = train_caches(kind, (N_512_TRAIN,), IMG_512, rng)
        val = (rng.integers(0, 256, (N_512_VAL, 2, IMG_512, IMG_512, 1), dtype=np.uint8),)
        plan = (divmod(N_512_TRAIN, BATCH_512), divmod(N_512_VAL, BATCH_512))
    else:
        train = train_caches(kind, (N_512_X, N_512_Y), IMG_512, rng)
        val = tuple(rng.integers(0, 256, (N_512_VAL, IMG_512, IMG_512, 1), dtype=np.uint8)
                    for _ in range(2))
        plan = (divmod(min(N_512_X, N_512_Y), BATCH_512), divmod(N_512_VAL, BATCH_512))
    steps = plan[0][0] + (plan[0][1] > 0)
    launches, trainers, epochs, peaks = {}, {}, {}, {}
    for remat in ("off", "on"):
        on = remat == "on"
        cfg = gan_config(kind, tmp, IMG_512, BATCH_512, remat)
        floor = reset_memory()
        trainer = seeded_trainer(kind, cfg)
        if trainer.sampler.remat != on:
            raise AssertionError(f"--remat {remat} built a generator with remat {not on}")
        if kind == "pix2pix":
            per = with_adam(pix2pix_launches(IMG_512, BATCH_512, True, on),
                            pix2pix_launches(IMG_512, BATCH_512, False, on), trainer)
            tails = with_adam(pix2pix_launches(IMG_512, plan[0][1], True, on),
                              pix2pix_launches(IMG_512, plan[1][1], False, on), trainer)
        else:
            per = with_adam(*cyclegan_launches(IMG_512, cyclegan_batched(IMG_512, BATCH_512), on),
                            trainer)
            tails = None
        want, want_host, want_epoch = epoch_plan_counts(*per, *plan, tails)
        print(f"remat {remat}: 1 epoch of {steps} train steps (full {plan[0]}) and val (full "
              f"{plan[1]}); per full train step {per[0]}, per tail "
              f"{(tails or per)[0]}; per val step {per[1]}")
        mgr = CheckpointManager(os.path.join(tmp, f"{kind}_remat_{remat}"), max_to_keep=1)
        epochs[remat] = recorded_epochs(trainer)

        def fit():
            return (*trainer.fit(*train, *val, val[0][:1], tmp, checkpoint_manager=mgr), mgr)

        counted, peaks[remat] = check_fit(trainer, lambda: seeded_trainer(kind, cfg), fit, want,
                                          want_host, want_epoch, steps, floor)
        for name, n in counted.items():
            launches[name] = launches.get(name, 0) + n
        trainers[remat] = trainer
    compare_epochs(trainers["on"], trainers["off"], epochs["on"], epochs["off"],
                   "remat vs remat-free epochs")
    print(f"peak device memory of fit: remat off {peaks['off']:.2f} GiB, on {peaks['on']:.2f} "
          f"GiB ({smi})")

    # one step from the fitted state, the remat trainer: kernel path vs plain path
    u8 = [torch.from_numpy(a[:BATCH_512]).to("cuda") for a in train]
    gx, gy = (torch.Generator(device="cuda").manual_seed(SEED + i) for i in (4, 5))
    if kind == "pix2pix":
        x, y = paired_jitter_batch(u8[0], gx, img_size=IMG_512, dtype=torch.bfloat16)
        draws = lambda t: t._draws(SEED, 0, 0, 0, 0)
    else:
        x, y = (single_jitter_batch(u, gen, img_size=IMG_512, dtype=torch.bfloat16)
                for u, gen in zip(u8, (gx, gy)))
        draws = lambda t: [t._draws(SEED, 0, 0, 0, k)
                           for k in range(len(t.passes(BATCH_512, BATCH_512)))]
    trainer32 = seeded_trainer(kind, gan_config(kind, tmp, IMG_512, BATCH_512, "on", "fp32"))
    trainer32.load_state(trainers["on"].state())
    check_step_paths(trainers["on"], trainer32, x, y, draws)
    if kind == "cyclegan":
        check_forms(trainers["on"], trainer32, x, y)
    del trainer32

    caches = tuple(torch.from_numpy(a).to("cuda") for a in train)
    for remat in ("off", "on"):
        print(f"remat {remat}, graph step at {IMG_512}², batch {BATCH_512} ({smi}):")
        graph_step_numbers(trainers[remat], caches, BATCH_512)
    if kind == "cyclegan":
        trace_dgrad(lambda: trainers["off"]._step(*u8, 0, 0, 0))
        del trainers, caches
        reset_memory()
        form_sweep(tmp, IMG_512, BATCH_512, smi)
        print(f"both forms at {IMG_512}², batch {BATCH_512}, remat on ({smi}):")
        form_numbers(tmp, IMG_512, BATCH_512, profile=False, remat="on")
    return launches


def predict_512() -> dict:
    """14e: ``generate_batched`` of both models at 512², 32 seeded images in
    chunks of 16, through ``check_predict``. Returns the launches."""
    launches = {}
    for kind, norm_type in (("pix2pix", blocks.BatchNorm), ("cyclegan", blocks.InstanceNorm)):
        argv = ["--output", "out", "--predict", "--weights", "run", "--img-size", str(IMG_512),
                "--channels", "1", "--dtype"]
        parse = (lambda a: parse_pix2pix(["--data", "d", *a])) if kind == "pix2pix" else (
            lambda a: parse_cyclegan(["--input-images", "x", *a]))
        trainer = seeded_trainer(kind, parse(argv + ["bf16"]))
        u8 = np.random.default_rng(SEED + 20).integers(0, 256, (N_IMAGES, IMG_512, IMG_512, 1),
                                                       dtype=np.uint8)
        print(f"{kind} generator at {IMG_512}², depth {generator_depth(IMG_512)}:")
        got, _ = check_predict(trainer, seeded_trainer(kind, parse(argv + ["fp32"])), u8, norm_type)
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    return launches


def remat_frontier(tmp: str, smi: str) -> None:
    """14f: graph step ms and peak device memory with remat off and on at
    each FRONTIER configuration, each on a fresh seeded trainer over a
    resident cache of one batch: an epoch of FRONTIER_STEPS steps (the
    warm-up, the capture, replays) with its launches counted on the card
    against the derivation (``counted_epoch``; CycleGAN in the form
    ``batched_pass_max`` selects: batched at batch 1), then a timed epoch of FRONTIER_STEPS
    replays; the peak covers both, the graph pool included. Then, per model,
    the remat-free peaks fitted to a line in 256²-image equivalents (what
    ``use_remat`` rests on) beside ``REMAT_FREE_PEAK``, and what ``auto``
    decides at each configuration on this card."""
    rows = []
    for kind, size, batch in FRONTIER:
        for remat in ("off", "on"):
            floor = reset_memory()
            trainer = seeded_trainer(kind, gan_config(kind, tmp, size, batch, remat))
            caches = tuple(torch.from_numpy(a).to("cuda") for a in train_caches(
                kind, (batch, batch), size, np.random.default_rng(SEED + 21)))
            idx = tuple(torch.arange(FRONTIER_STEPS * batch, device="cuda").view(
                FRONTIER_STEPS, batch).remainder(batch) for _ in caches)
            on = remat == "on"
            per_step = with_adam(cyclegan_launches(size, cyclegan_batched(size, batch), on)[0]
                                 if kind == "cyclegan" else pix2pix_launches(size, batch, True, on),
                                 {}, trainer)[0]
            first = counted_epoch(lambda: trainer._cached_epoch(caches, idx, 0, True), per_step,
                                  FRONTIER_STEPS, f"  {kind} {size}² batch {batch} remat {remat}")
            t0 = time.perf_counter()
            second = trainer._cached_epoch(caches, idx, 1, True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / FRONTIER_STEPS * 1e3
            peak = (torch.cuda.max_memory_allocated() - floor) / 2**30
            if not (torch.isfinite(first).all() and torch.isfinite(second).all()):
                raise AssertionError(f"{kind} {size}² batch {batch} remat {remat}: a loss is "
                                     "not finite")
            if trainer.epoch_counts != {"eager": 1, "captures": 1,
                                        "replays": 2 * FRONTIER_STEPS - 1}:
                raise AssertionError(f"the frontier's runner ran {trainer.epoch_counts}")
            rows.append((kind, size, batch, remat, ms, peak))
            print(f"  {kind} {size}² batch {batch} remat {remat}: {ms:.3f} ms a step, peak "
                  f"{peak:.2f} GiB", flush=True)
            del trainer, caches, idx, first, second
    total = device_bytes(torch.device("cuda"))
    print(f"\nremat frontier, graph steps, bf16 ({smi}; {total / 2**30:.2f} GiB on the card):")
    print(f"{'model':>9} {'size':>5} {'batch':>6} {'256²-eq':>8} {'off_ms':>9} {'on_ms':>9} "
          f"{'on/off':>7} {'off_pairs/s':>12} {'on_pairs/s':>11} {'off_GiB':>8} {'on_GiB':>7} "
          f"{'on/off':>7} {'predicted_off_GiB':>18} {'auto':>5}")
    by = {(k, s, b, r): (ms, peak) for k, s, b, r, ms, peak in rows}
    for kind, size, batch in FRONTIER:
        (off_ms, off_gib), (on_ms, on_gib) = by[kind, size, batch, "off"], by[kind, size, batch, "on"]
        eq = batch * (size / 256) ** 2
        fixed, per_eq = REMAT_FREE_PEAK[kind]
        auto = use_remat(gan_config(kind, tmp, size, batch, "auto"), total)
        print(f"{kind:>9} {size:>5} {batch:>6} {eq:>8g} {off_ms:>9.3f} {on_ms:>9.3f} "
              f"{on_ms / off_ms:>7.3f} {batch / off_ms * 1e3:>12.2f} {batch / on_ms * 1e3:>11.2f} "
              f"{off_gib:>8.2f} {on_gib:>7.2f} {on_gib / off_gib:>7.3f} "
              f"{(fixed + per_eq * eq) / 2**30:>18.2f} {'on' if auto else 'off':>5}")
    for kind in ("pix2pix", "cyclegan"):
        pts = [(b * (s / 256) ** 2, by[k, s, b, "off"][1]) for k, s, b in FRONTIER if k == kind]
        slope, fixed = np.polyfit([p[0] for p in pts], [p[1] for p in pts], 1)
        # the same slope (to 4 decimals), raised until no point as printed (to
        # 0.01 GiB) lies above the line (REMAT_FREE_PEAK)
        covering = math.ceil(max(round(peak, 2) - round(slope, 4) * eq for eq, peak in pts)
                             * 1000) / 1000
        budget = (1 - DEVICE_CACHE_FRACTION) * total / 2**30
        print(f"{kind}: remat-free peak ~ {fixed:.3f} GiB + {slope:.4f} GiB per 256²-image "
              f"equivalent (least squares over {len(pts)} configurations; residuals "
              f"{[round(float(peak - fixed - slope * eq), 3) for eq, peak in pts]} GiB), auto "
              f"would turn remat on past {(budget - fixed) / slope:.0f} equivalents on this card; "
              f"the line that under-predicts no point: {covering:.3f} GiB + {slope:.4f} GiB, on "
              f"past {(budget - covering) / round(slope, 4):.0f}")


def run_512(tmp: str, smi: str) -> dict:
    """Phase 14. Returns the kernel launch counts of the main-path runs
    (14c, 14d, 14e)."""
    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    phase(f"14a. K1 and K2 vs plain at every {IMG_512}² norm site ({smi})")
    check_norms_512()
    phase(f"14b. stem kernel (S) vs plain, every stem shape at {IMG_512}² ({smi})")
    check_stem(IMG_512)
    phase(f"14c. Pix2Pix fit at {IMG_512}², batch {BATCH_512}, remat off and on ({smi})")
    add(fit_512("pix2pix", tmp, smi))
    phase(f"14d. CycleGAN fit at {IMG_512}², batch {BATCH_512}, remat off and on ({smi})")
    add(fit_512("cyclegan", tmp, smi))
    phase(f"14e. predict at {IMG_512}², both models ({smi})")
    add(predict_512())
    phase(f"14f. the remat frontier ({smi})")
    remat_frontier(tmp, smi)
    print(f"phase 14 launches, counted on the card: {launches}")
    return launches


# ---------------------------------------------------------------- phase 15
DP_RANKS = 2            # 15b: ranks sharing the one card over gloo
DP_BATCH = 4            # 15b: Pix2Pix's global batch with cross-replica batch norm
DP_CLI_EPOCHS = 2       # 15c: the second epoch's [perf] line is read
# 15b: CycleGAN at a global batch of 2 over the 2 ranks: 2 full steps of a
# row per rank and a zip tail of 1 X and 2 Y rows; val 1 full step and 1 row
N_DP_X, N_DP_Y, N_DP_VAL = 5, 6, 3
DP_TIMEOUT = timedelta(seconds=300)   # a 15b group that hangs fails


def same_state(a, b) -> bool:
    """Every parameter and Adam state tensor of two trainers equal, bit for bit."""
    for name in a.nets:
        if not all(torch.equal(p, q) for p, q in zip(a.params[name], b.params[name])):
            return False
        sa, sb = a.opts[name].state_dict()["state"], b.opts[name].state_dict()["state"]
        if sa.keys() != sb.keys() or not all(torch.equal(v, sb[i][k]) for i, st in sa.items()
                                             for k, v in st.items()):
            return False
    return True


def dp_world_one(tmp: str, smi: str) -> dict:
    """15a: Pix2Pix at batch 32 (phase 10's data and seed) and CycleGAN at
    batch 8 (phase 7's), one ``fit`` epoch each through the data-parallel
    path at a world of one over NCCL, in this process, against the same
    ``fit`` without replicas: losses, parameters and Adam's state bit for
    bit, the full steps as graph replays (the captured step holds the
    group's all-reduces), launches counted on the card; then the graph step
    of both in turns. Returns the launches of the DP fits."""
    store = dist.FileStore(os.path.join(tmp, "nccl_store"), 1)
    replicas = parallel.join(0, 1, torch.device("cuda", 0), store=store)
    launches = {}
    try:
        pad = IMG_SIZE + 30
        rng = np.random.default_rng(SEED + 8)
        p2p = (rng.integers(0, 256, (N_P2P_TRAIN, 2, pad, pad, 1), dtype=np.uint8),
               rng.integers(0, 256, (N_P2P_VAL, 2, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8),
               rng.integers(0, 256, (1, 2, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8))
        rng = np.random.default_rng(SEED + 3)
        cg = (rng.integers(0, 256, (N_TRAIN_X, pad, pad, 1), dtype=np.uint8),
              rng.integers(0, 256, (N_TRAIN_Y, pad, pad, 1), dtype=np.uint8),
              *(rng.integers(0, 256, (n, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8)
                for n in (N_VAL, N_VAL, 1)))
        # (model, batch, data, its train caches, trainer, parser, the data
        # flags, train and val rows of the epoch)
        runs = (("Pix2Pix", P2P_BATCH, p2p, 1, Pix2PixTrainer, parse_pix2pix,
                 ["--data", tmp], N_P2P_TRAIN, N_P2P_VAL),
                ("CycleGAN", TRAIN_BATCH, cg, 2, CycleGANTrainer, parse_cyclegan,
                 ["--input-images", tmp, "--target-images", tmp],
                 min(N_TRAIN_X, N_TRAIN_Y), N_VAL))
        for what, batch, data, n_caches, cls, parse, first, n_train, n_val in runs:
            cfg = parse([*first, "--output", tmp, "--train", "--epochs", "1", "--img-size",
                         str(IMG_SIZE), "--batch-size", str(batch), "--dtype", "bf16",
                         "--num-devices", "1"])
            reset_memory()
            single, dp = cls(cfg), cls(cfg, replicas)
            offsets_from_seed(single)
            offsets_from_seed(dp)
            fits = {}
            for label, trainer in (("single", single), ("dp", dp)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fits[label], counted = device_launches(lambda: trainer.fit(*data, tmp))
                print(f"{what} fit, {label}: {time.perf_counter() - t0:.2f} s with the set-up; "
                      f"runner {trainer.epoch_counts}; launches counted on the card {counted}")
                if label == "dp":
                    for name, n in counted.items():
                        launches[name] = launches.get(name, 0) + n
            _, _, want_epoch = epoch_plan_counts({}, {}, divmod(n_train, batch),
                                                 divmod(n_val, batch))
            equal = fits["single"] == fits["dp"] and same_state(single, dp)
            print(f"{what} at a world of 1 over NCCL against no replicas: losses, parameters and "
                  f"Adam's state {'equal bit for bit' if equal else 'DIFFER'}; runner "
                  f"{dp.epoch_counts}, expected {want_epoch}")
            if not equal:
                raise AssertionError(f"{what}: the DP fit at a world of 1 differs from the fit")
            if dp.epoch_counts != want_epoch or not dp.epoch_counts["replays"]:
                raise AssertionError(f"{what}: the DP epoch did not run as graph replays")
            caches = tuple(torch.from_numpy(a).to("cuda") for a in data[:n_caches])
            rows = tuple(torch.arange(GRAPH_STEPS * batch, device="cuda").remainder(
                c.shape[0]).view(GRAPH_STEPS, batch) for c in caches)
            paths = {label: (lambda t=t: t._cached_epoch(caches, rows, 1, True), GRAPH_STEPS,
                             contextlib.nullcontext) for label, t in (("dp", dp),
                                                                      ("single", single))}
            ms = timed_paths(paths, rounds=2, reps=3)
            med = {label: float(np.median(v)) for label, v in ms.items()}
            print(f"{what} graph step at batch {batch}, {smi}: DP at a world of 1 median "
                  f"{med['dp']:.3f} ms (rounds {[round(r, 3) for r in ms['dp']]}), without "
                  f"replicas {med['single']:.3f} ms (rounds "
                  f"{[round(r, 3) for r in ms['single']]}); DP/single {med['dp'] / med['single']:.3f}")
            del single, dp, caches, fits
    finally:
        parallel.leave(replicas)
    return launches


def _grads_err(got: dict, want: dict) -> dict:
    return {k: _rel(torch.cat([g.flatten().float() for g in got[k]]),
                    torch.cat([g.flatten().float() for g in want[k]])) for k in got}


def dp_rank_checks(replicas, tmp: str) -> dict:
    """15b on one of the ranks that share the card; returns what rank 0
    reports and every rank's launches."""
    out = {"launches": {}}
    lead = replicas.rank == 0
    r, w = replicas.rank, replicas.size
    if not lead:
        silence()

    def count(fn):
        result, counted = device_launches(fn)
        for name, n in counted.items():
            out["launches"][name] = out["launches"].get(name, 0) + n
        return result, counted

    def pix2pix(batch, cross):
        cfg = parse_pix2pix(["--data", tmp, "--output", tmp, "--train", "--epochs", "1",
                             "--img-size", str(IMG_SIZE), "--batch-size", str(batch), "--dtype",
                             "bf16", "--bn-cross-replica", cross, "--num-devices", str(w)])
        dp = Pix2PixTrainer(cfg, replicas)
        single = Pix2PixTrainer(cfg, parallel.single(replicas.device)) if lead else None
        for t in (dp, single):
            if t is not None:
                offsets_from_seed(t)
        rng = np.random.default_rng(SEED + 15)
        x, y = (torch.from_numpy(rng.uniform(-1, 1, (batch, IMG_SIZE, IMG_SIZE, 1))
                                 .astype(np.float32)).to("cuda", torch.bfloat16)
                for _ in range(2))
        masks = dp._masks(dp.gen, torch.Generator(device="cuda").manual_seed(SEED + 16), batch)
        b = dp.local_batch
        mine = lambda m: [t[r * b:(r + 1) * b] for t in m]
        return dp, single, x, y, masks, mine

    # global batch 4 with cross-replica batch norm, against one process at batch 4
    dp, single, x, y, masks, mine = pix2pix(DP_BATCH, "true")
    (grads, losses), _ = count(lambda: dp.gradients(*mine([x, y]), masks=[mine(masks)],
                                                    bn_group=dp.bn_group))
    if lead:
        want, want_losses = single.gradients(x, y, masks=[masks])
        out["cross"] = (((losses - want_losses).abs() / want_losses.abs()).max().item(),
                        _grads_err(grads, want))
    del dp, single, grads

    # global batch 2 with per-replica batch norm (K1 and K2 at a batch of one),
    # against the mean of two batch-1 steps; then the DP step on the plain path
    dp, single, x, y, masks, mine = pix2pix(2, "false")
    step = lambda: dp.gradients(*mine([x, y]), masks=[mine(masks)])
    (grads, losses), counted = count(step)
    out["per_replica_launches"] = counted
    with plain_path("plain"):
        plain, plain_losses = step()
    out["kernel_vs_plain"] = (((losses - plain_losses).abs() / plain_losses.abs()).max().item(),
                              _grads_err(grads, plain))
    if lead:
        halves = [single.gradients(x[i:i + 1], y[i:i + 1], masks=[[m[i:i + 1] for m in masks]])
                  for i in range(2)]
        mean = {k: [(a + c) / 2 for a, c in zip(halves[0][0][k], halves[1][0][k])]
                for k in grads}
        mean_losses = (halves[0][1] + halves[1][1]) / 2
        out["per_replica"] = (((losses - mean_losses).abs() / mean_losses.abs()).max().item(),
                              _grads_err(grads, mean))
    out["step_ms"] = median_ms(step, reps=3)
    del dp, single, grads, plain

    # a CycleGAN fit epoch at a global batch of 2, with a zip tail
    cfg = parse_cyclegan(["--input-images", tmp, "--target-images", tmp, "--output", tmp,
                          "--train", "--epochs", "1", "--img-size", str(IMG_SIZE),
                          "--batch-size", "2", "--dtype", "bf16", "--num-devices", str(w)])
    trainer = CycleGANTrainer(cfg, replicas)
    offsets_from_seed(trainer)
    rng = np.random.default_rng(SEED + 17)
    pad = IMG_SIZE + 30
    data = (rng.integers(0, 256, (N_DP_X, pad, pad, 1), dtype=np.uint8),
            rng.integers(0, 256, (N_DP_Y, pad, pad, 1), dtype=np.uint8),
            *(rng.integers(0, 256, (n, IMG_SIZE, IMG_SIZE, 1), dtype=np.uint8)
              for n in (N_DP_VAL, N_DP_VAL, 1)))
    (train_cost, val_cost), _ = count(lambda: trainer.fit(*data, os.path.join(tmp, "cyclegan")))
    sums = torch.stack([torch.cat([p.detach().flatten() for p in trainer.params[k]]).double().sum()
                        for k in NETWORKS_CYCLEGAN]).cpu()
    high, low = sums.clone(), -sums
    dist.all_reduce(high, op=dist.ReduceOp.MAX, group=replicas.group)
    dist.all_reduce(low, op=dist.ReduceOp.MAX, group=replicas.group)
    out["cyclegan"] = {"spread": (high + low).tolist(), "counts": dict(trainer.epoch_counts),
                       "losses": [v[0] for d in (train_cost, val_cost) for v in d.values()]}
    return out


def _dp_rank(rank: int, tmp: str, size: int) -> None:
    """A spawned 15b rank: both ranks on the one card, over gloo. Rank 0
    makes sure of the kernel library (phase 2 built it; the name is a hash
    of the sources) before the others load it."""
    tf32_off()
    store = dist.FileStore(os.path.join(tmp, "gloo_store"), size)
    replicas = parallel.join(rank, size, torch.device("cuda", 0), store=store, backend="gloo",
                             timeout=DP_TIMEOUT)
    try:
        if rank == 0:
            build.build()
        dist.barrier()
        torch.save(dp_rank_checks(replicas, tmp), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        parallel.leave(replicas)


def dp_two_ranks(tmp: str, smi: str) -> dict:
    """15b: two spawned ranks on the one card over gloo. Returns the launches
    of both ranks' main-path runs."""
    torch.multiprocessing.start_processes(_dp_rank, args=(tmp, DP_RANKS), nprocs=DP_RANKS,
                                          start_method="spawn")
    res = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(DP_RANKS)]
    lead = res[0]
    fmt = lambda d: {k: f"{v:.3e}" for k, v in d.items()}
    ok = True
    for key, what in (("cross", f"Pix2Pix, {DP_RANKS} ranks at a global batch of {DP_BATCH}, "
                                "cross-replica batch norm, against one process at the batch"),
                      ("per_replica", f"Pix2Pix, {DP_RANKS} ranks at a global batch of 2, "
                                      "per-replica batch norm, against the mean of two "
                                      "batch-1 steps"),
                      ("kernel_vs_plain", "that per-replica DP step, kernel vs plain path")):
        loss_err, grad_err = lead[key]
        good = loss_err <= STEP_TOL["bf16"][0] and max(grad_err.values()) <= STEP_TOL["bf16"][1]
        print(f"{what}: losses max relative error {loss_err:.3e} (tol {STEP_TOL['bf16'][0]:g}), "
              f"gradients relative L2 error {fmt(grad_err)} (tol {STEP_TOL['bf16'][1]:g})")
        ok &= good
    per_rank = [x["per_replica_launches"] for x in res]
    print(f"per-replica DP step launches counted on the card, by rank: {per_rank}")
    print(f"per-replica DP step, rank 0: median {lead['step_ms']:.1f} ms, {smi}; not a scaling "
          "number: two ranks share one card, and gloo stages every all-reduce through the host")
    if not all(x[name] > 0 for x in per_rank for name in ("instance_norm_fwd",
                                                          "instance_norm_bwd")):
        raise AssertionError("K1 or K2 did not launch in the per-replica batch-norm step")
    spread = [x["cyclegan"]["spread"] for x in res]
    counts = [x["cyclegan"]["counts"] for x in res]
    print(f"CycleGAN fit, {DP_RANKS} ranks at a global batch of 2 with a zip tail: parameter "
          f"checksums, max − min over the ranks per network {spread[0]}; runner {counts}; "
          f"losses finite {all(math.isfinite(v) for x in res for v in x['cyclegan']['losses'])}")
    want = {"eager": 3, "captures": 0, "replays": 0, "eager_by_backend": 3}
    if any(v != 0.0 for v in spread[0]) or any(c != want for c in counts):
        raise AssertionError("the CycleGAN ranks parted, or the runner did not run eagerly by "
                             "the gloo rule")
    if not all(math.isfinite(v) for x in res for v in x["cyclegan"]["losses"]):
        raise AssertionError("a CycleGAN DP loss is not finite")
    if not ok:
        raise AssertionError("a DP step disagrees with its reference")
    launches = {}
    for x in res:
        for name, n in x["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


def perf_rate(stdout: str) -> float:
    """images/sec of the last ``[perf]`` line of a run under GAN_TPU_PERF=1."""
    lines = [line for line in stdout.splitlines() if line.startswith("[perf]")]
    if not lines:
        raise AssertionError("the run printed no [perf] line")
    return float(lines[-1].split(": ")[1].split()[0])


def _cli_rank(cfg, replicas) -> None:
    """A rank of 15c's run: the Pix2Pix CLI's ``run``, with its loss
    figures and image grids stubbed (the card's machine has no
    matplotlib)."""
    from gan_tpu_torch import pix2pix
    from gan_tpu_torch.train import pix2pix_trainer

    pix2pix.write_loss_figs = lambda *args, **kwargs: None
    pix2pix_trainer.save_image_grid = lambda *args, **kwargs: None
    pix2pix.run(cfg, replicas)


def cli_main(argv: list) -> None:
    """The Pix2Pix CLI's ``main`` on ``argv`` through ``parallel.launch``
    (which spawns the ranks that ``--num-devices`` asks for), each rank
    ``_cli_rank``."""
    parallel.launch(_cli_rank, parse_pix2pix(argv))


def dp_cli(tmp: str, smi: str) -> None:
    """15c: the Pix2Pix CLI path with --num-devices N = min(cards, 4) over
    NCCL, against N = 1, on seeded noise PNGs, each in a process of its own
    (``cli_main``), where the machine has two cards or more; on one card it
    says that it did not run, and why."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"15c did not run: the machine has count {cards} card; NCCL at 2-4 ranks needs as "
              "many cards")
        return
    n = min(cards, 4)
    data = os.path.join(tmp, "pairs")
    write_noise_pngs(data, 8 * P2P_BATCH + 2 * P2P_BATCH, (IMG_SIZE, 2 * IMG_SIZE), SEED + 18)
    rates = {}
    for ranks in (1, n):
        argv = ["--data", data, "--output", os.path.join(tmp, f"cli_{ranks}"), "--train",
                "--epochs", str(DP_CLI_EPOCHS), "--img-size", str(IMG_SIZE), "--batch-size",
                str(P2P_BATCH * ranks), "--dtype", "bf16", "--logging", "false",
                "--num-devices", str(ranks), "--test-img", "1"]
        proc = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.cli_main({argv!r})"],
            capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, GAN_TPU_PERF="1"))
        if proc.returncode != 0:
            raise AssertionError(f"the CLI at --num-devices {ranks} failed:\n{proc.stderr[-4000:]}")
        rates[ranks] = perf_rate(proc.stdout)
    print(f"Pix2Pix CLI, {P2P_BATCH} pairs per card, epoch {DP_CLI_EPOCHS}, {smi}: "
          f"--num-devices 1 {rates[1]:.1f} pairs/s; --num-devices {n} {rates[n]:.1f} pairs/s, "
          f"{rates[n] / n:.1f} per card ({rates[n] / n / rates[1]:.2f} of one card's)")


def run_data_parallel(tmp: str, smi: str) -> dict:
    """Phase 15. Returns the kernel launch counts of its main-path runs."""
    launches = {}
    phase(f"15a. data parallelism at a world of 1 over NCCL: Pix2Pix batch {P2P_BATCH} and "
          f"CycleGAN batch {TRAIN_BATCH} fit against fit without replicas")
    for name, n in dp_world_one(tmp, smi).items():
        launches[name] = launches.get(name, 0) + n
    phase(f"15b. {DP_RANKS} ranks on the one card over gloo (device count "
          f"{torch.cuda.device_count()})")
    for name, n in dp_two_ranks(tmp, smi).items():
        launches[name] = launches.get(name, 0) + n
    phase("15c. NCCL over min(cards, 4) ranks through the CLI")
    dp_cli(tmp, smi)
    print(f"phase 15 launches, counted on the card: {launches}")
    if not all(launches.get(name, 0) > 0 for name in SOURCES):
        raise AssertionError("a kernel of phase 15's paths was never launched")
    return launches


# phase 16: the fault fence, each run a process of its own through the CLI's
# main. CycleGAN at 256², depth 8, bf16, batch 2, 8 images a domain (1 test,
# 1 val: 6 X and 7 Y train rows, 3 full steps an epoch) and Pix2Pix at 256²,
# batch 4, 16 pairs streamed from the files (1 test, 2 val: 13 train pairs,
# 3 full steps and a 1-pair tail), 4 epochs with --checkpoint-every 2
FENCE_EPOCHS, FENCE_EVERY = 4, 2
FENCE_AT = (2, 1)      # (train epoch index, step within it) where the faults strike
FENCE_CG = (2, 8)      # CycleGAN (batch, images per domain)
FENCE_P2P = (4, 16)    # Pix2Pix (batch, pairs)
STICKY_EXIT_S = 60.0   # the most seconds from the sticky fault to exit 17
FENCE_RUN_S = 600      # a child that outlasts this fails the phase
TRAP_SOURCE = r"""
extern "C" __global__ void gt_trap_kernel() { __trap(); }
extern "C" int gt_trap(void* stream) {
  gt_trap_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def build_trap() -> tuple[str, float]:
    """The ``__trap()`` kernel of 16a's sticky fault, built from
    ``TRAP_SOURCE`` with ``load_inline`` into ``gan_tpu_torch/build/trap``:
    a plain C interface and no torch headers, so nvcc takes seconds.
    Returns (library path, seconds)."""
    from torch.utils import cpp_extension

    directory = os.path.join(build.BUILD_DIR, "trap")
    os.makedirs(directory, exist_ok=True)
    t0 = time.perf_counter()
    path = cpp_extension.load_inline(
        "gt_trap", cpp_sources="", cuda_sources=TRAP_SOURCE, build_directory=directory,
        extra_cuda_cflags=["-gencode=arch=compute_90a,code=sm_90a"], is_python_module=False,
        no_implicit_headers=True)
    return path, time.perf_counter() - t0


def fence_child(kind: str, fault: str, argv: list, trap: str = "") -> None:
    """One run of phase 16, in a process of its own: the port CLI's ``main``
    on ``argv`` (the loss figures and image grids stubbed: no matplotlib on
    the card's machine), with ``fault`` at step ``FENCE_AT[1]`` of train
    epoch ``FENCE_AT[0]``: ``none``; ``runtime``, a RuntimeError raised by a
    wrapper of ``CachedEpoch._step`` after the step ran; ``sticky``, the
    ``__trap()`` kernel of the library ``trap`` launched on the trainer's
    stream after the step. Prints ``[fence]`` lines, a JSON object each:
    host times of the fault and of the steps around it, each restore and
    each checkpoint save, and at the end the kernels' launches counted on
    the card."""
    import ctypes

    from gan_tpu_torch import cycle_gan, pix2pix
    from gan_tpu_torch.train import cyclegan_trainer, pix2pix_trainer

    cli, module = ((cycle_gan, cyclegan_trainer) if kind == "cyclegan"
                   else (pix2pix, pix2pix_trainer))
    cli.write_loss_figs = lambda *args, **kwargs: None
    module.save_image_grid = lambda *args, **kwargs: None
    cls = module.CycleGANTrainer if kind == "cyclegan" else module.Pix2PixTrainer
    at = {"epoch": None, "step": 0, "fired": None, "steps": 0}

    def report(**record):
        print(f"[fence] {json.dumps(record)}", flush=True)

    real_run_epoch, real_step = cls.run_epoch, loop.CachedEpoch._step
    real_save, real_restore = CheckpointManager.save, CheckpointManager.restore

    def run_epoch(self, *args, training):
        at["epoch"], at["step"] = (args[-1] if training else None), 0
        return real_run_epoch(self, *args, training=training)

    def step(runner):
        at["steps"] += 1
        if at["steps"] == 1:
            report(first_step=time.time())
        replayed = runner.graph is not None
        out = real_step(runner)
        if at["fired"] is not None and "after" not in at:
            torch.cuda.synchronize()
            at["after"] = time.time()
            report(after=at["after"], capture_s=runner.capture_s)
        if (fault != "none" and at["fired"] is None
                and (at["epoch"], at["step"]) == FENCE_AT):
            at["fired"] = time.time()
            report(fault=at["fired"], epoch=at["epoch"], step=at["step"], replayed=replayed)
            if fault == "runtime":
                raise RuntimeError("injected fault after a replayed step")
            lib = ctypes.CDLL(trap)
            lib.gt_trap.argtypes = [ctypes.c_void_p]
            lib.gt_trap(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        at["step"] += 1
        return out

    def save(self, epoch, state, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(self, epoch, state, **kwargs)
        seconds = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(self.directory, str(epoch), "state.pt"))
        report(save=[epoch, nbytes, seconds])

    def restore(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = real_restore(self, *args, **kwargs)
        report(restore=time.perf_counter() - t0)
        return out

    cls.run_epoch, loop.CachedEpoch._step = run_epoch, step
    CheckpointManager.save, CheckpointManager.restore = save, restore
    parse = parse_cyclegan if kind == "cyclegan" else parse_pix2pix
    cli.main(parse(argv))
    report(launches=kernels.card_launches())


def fence_run(kind: str, fault: str, argv: list, trap: str = "") -> dict:
    """``fence_child`` in a process of its own. Returns its exit code, output,
    run directory, the host times of its start and end, and its ``[fence]``
    lines parsed."""
    code = f"import chip_smoke; chip_smoke.fence_child({kind!r}, {fault!r}, {argv!r}, {trap!r})"
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)), timeout=FENCE_RUN_S)
    end = time.time()
    out = argv[argv.index("--output") + 1]
    runs = sorted(os.listdir(out)) if os.path.isdir(out) else []
    res = {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr, "start": t0,
           "end": end, "run": os.path.join(out, runs[0]) if len(runs) == 1 else None,
           "saves": [], "restores": []}
    for line in proc.stdout.splitlines():
        if line.startswith("[fence] "):
            record = json.loads(line[len("[fence] "):])
            for key in ("save", "restore"):
                if key in record:
                    res[key + "s"].append(record.pop(key))
            res.update(record)
    return res


def _state_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _state_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _state_leaves(v, path + (i,))
    else:
        yield path, tree


def fence_diff(run: str, want: str, metrics_from: int = 0) -> float:
    """The largest absolute difference between two runs: their train and val
    metrics (``want``'s from epoch ``metrics_from`` on) and every value of
    their final checkpoints. 0.0: bit for bit; inf: epochs, keys or shapes
    differ."""
    worst = 0.0
    for name in ("train_metrics.json", "val_metrics.json"):
        with open(os.path.join(run, "logs", name)) as f:
            got = json.load(f)
        with open(os.path.join(want, "logs", name)) as f:
            ref = {k: v[metrics_from:] for k, v in json.load(f).items()}
        if got.keys() != ref.keys() or any(len(got[k]) != len(ref[k]) for k in ref):
            return math.inf
        worst = max([worst] + [abs(a - b) for k in ref for a, b in zip(got[k], ref[k])])
    states = []
    for r in (run, want):
        mgr = CheckpointManager(os.path.join(r, "training_checkpoints"))
        states.append((mgr.latest_epoch(), list(_state_leaves(mgr.restore(map_location="cpu")))))
    (e1, got), (e2, ref) = states
    if e1 != e2 or [p for p, _ in got] != [p for p, _ in ref]:
        return math.inf
    for (_, a), (_, b) in zip(got, ref):
        if isinstance(a, torch.Tensor):
            if a.shape != b.shape:
                return math.inf
            if a.numel():
                worst = max(worst, float((a.double() - b.double()).abs().max()))
        elif a != b:
            return math.inf
    return worst


def _fence_ok(res: dict, what: str) -> None:
    if res["rc"] != 0 or res["run"] is None:
        raise AssertionError(f"{what} failed (exit {res['rc']}):\n{res['stdout'][-3000:]}\n"
                             f"{res['stderr'][-3000:]}")


def _held(what: str, diff: float, spread: Optional[float], clean_again) -> float:
    """Holds ``diff`` (a faulted run against the clean one) at 0, or, where
    it is not 0, within the spread of two clean runs, which it measures
    once (``clean_again()``). Returns the spread (None: not measured)."""
    if diff == 0.0:
        print(f"{what}: bit for bit equal to the clean run")
        return spread
    if spread is None:
        spread = clean_again()
        print(f"two clean runs differ by at most {spread:.6e}")
    print(f"{what}: largest difference from the clean run {diff:.6e} (clean runs' spread "
          f"{spread:.6e})")
    if not diff <= spread:
        raise AssertionError(f"{what} differs from the clean run beyond the clean runs' spread")
    return spread


def check_capture_faults() -> None:
    """16c: a fault inside a graph capture. A step that raises while it is
    captured (its warm-up ran) leaves the current stream as it was and no
    stream capturing, and a fresh runner then captures and replays equal to
    the eager step; so does a step whose capture is invalidated by a
    synchronisation, where a fresh runner's first attempt may meet the
    capture's error, as a rewind's would (printed, not a gate)."""
    dev = torch.device("cuda", 0)
    x = torch.linspace(-1, 1, 64 * 64, device=dev).reshape(64, 64)
    stream = torch.cuda.current_stream(dev)
    for name, bad in (("raise", lambda y: (_ for _ in ()).throw(RuntimeError("injected"))),
                      ("invalidate", lambda y: y.sum().item())):
        calls = []

        def faulty():
            calls.append(1)
            y = x @ x
            if len(calls) == 2:   # the capture; the first call is its warm-up
                bad(y)
            return y.sum(0)

        counts = {"eager": 0, "captures": 0, "replays": 0}
        try:
            loop.make_cached_epoch(faulty, dev, counts=counts)(3, lambda s: None)
            raise AssertionError(f"16c {name}: the capture did not fail")
        except RuntimeError as err:
            msg = str(err).splitlines()[0]
        same, capturing = (torch.cuda.current_stream(dev) == stream,
                           torch.cuda.is_current_stream_capturing())
        print(f"16c capture that fails ({name}): {msg[:160]}; current stream restored {same}, "
              f"a stream capturing {capturing}")
        if not same or capturing:
            raise AssertionError("a failed capture left its stream current or capturing")
        tries = []
        for _ in range(2):
            counts = {"eager": 0, "captures": 0, "replays": 0}
            try:
                got = loop.make_cached_epoch(lambda: (x @ x).sum(0), dev, counts=counts)(
                    3, lambda s: None)
                torch.cuda.synchronize()
                tries.append(bool(torch.equal(got, (x @ x).sum(0).expand(3, -1))
                                  and counts == {"eager": 1, "captures": 1, "replays": 2}))
                break
            except RuntimeError as err:
                tries.append(str(err).splitlines()[0][:120])
        print(f"16c after it, a fresh runner (capture, 2 replays, equal to eager): {tries}")
        if name == "raise" and tries != [True]:
            raise AssertionError("no fresh capture after a capture that raised")


def run_fence(tmp: str, smi: str) -> dict:
    """Phase 16. Returns the kernel launch counts of its runs' main paths
    (every run but the sticky one, whose card can no longer be read)."""
    launches = {}

    def add(res):
        for name, n in res["launches"].items():
            launches[name] = launches.get(name, 0) + n

    held = reset_memory()   # the runs' processes share the card with this one's cache
    print(f"this process holds {held / 2**30:.2f} GiB of the card while the runs train")
    trap, seconds = build_trap()
    print(f"built the __trap() kernel {os.path.relpath(trap)} with load_inline in {seconds:.2f} s")
    phase(f"16a. CycleGAN at {IMG_SIZE}², depth {generator_depth(IMG_SIZE)}, bf16, batch "
          f"{FENCE_CG[0]}: a fault after a replayed step rewinds in-process; a sticky fault "
          f"exits {recovery.EXIT_CODE}")
    x, y = os.path.join(tmp, "x"), os.path.join(tmp, "y")
    write_noise_pngs(x, FENCE_CG[1], (IMG_SIZE, IMG_SIZE), SEED + 40)
    write_noise_pngs(y, FENCE_CG[1], (IMG_SIZE, IMG_SIZE), SEED + 41)

    def cg_argv(name, *extra):
        return ["--input-images", x, "--target-images", y, "--output", os.path.join(tmp, name),
                "--train", "--epochs", str(FENCE_EPOCHS), "--img-size", str(IMG_SIZE),
                "--batch-size", str(FENCE_CG[0]), "--test-img", "1", "--dtype", "bf16",
                "--logging", "false", "--num-devices", "1", "--checkpoint-every",
                str(FENCE_EVERY), *extra]

    clean = fence_run("cyclegan", "none", cg_argv("cg_clean"))
    _fence_ok(clean, "16a's clean run")
    add(clean)
    print(f"checkpoint saves of the clean run (epoch, GB, GB/s; the anchor holds no Adam state "
          f"yet), {smi}: " + ", ".join(f"({e}, {n / 1e9:.3f}, {n / t / 1e9:.3f})"
                                       for e, n, t in clean["saves"]))
    if not os.path.isdir(os.path.join(clean["run"], "training_checkpoints")) or os.path.isdir(
            os.path.join(clean["run"], "training_checkpoints", "0")):
        raise AssertionError("the clean run kept its anchor checkpoint, or saved none")
    spread = {"cyclegan": None, "pix2pix": None}

    def clean_again(kind, argv):
        def again():
            res = fence_run(kind, "none", argv)
            _fence_ok(res, f"{kind}'s second clean run")
            add(res)
            d = fence_diff(res["run"], runs[kind]["run"])
            shutil.rmtree(res["run"])
            return d
        return again

    runs = {"cyclegan": clean}
    rt = fence_run("cyclegan", "runtime", cg_argv("cg_runtime"))
    _fence_ok(rt, "16a's run with a RuntimeError")
    add(rt)
    if not rt.get("replayed") or len(rt["restores"]) != 1:
        raise AssertionError("the fault did not strike a replayed step, or the run did not "
                             "restore once")
    print(f"RuntimeError after a replayed step of epoch {FENCE_AT[0] + 1}, {smi}: "
          f"{rt['after'] - rt['fault']:.3f} s from the fault to the end of the first step "
          f"after the rewind (restore {rt['restores'][0]:.3f} s, then the warm-up step and "
          f"the recapture, {rt['capture_s']:.3f} s of it)")
    spread["cyclegan"] = _held("16a's rewound run", fence_diff(rt["run"], clean["run"]),
                               spread["cyclegan"], clean_again("cyclegan", cg_argv("cg_clean2")))
    shutil.rmtree(rt["run"])

    sticky = fence_run("cyclegan", "sticky", cg_argv("cg_sticky"), trap)
    exit_s = sticky["end"] - sticky.get("fault", math.inf)
    resume_line = f"Resume with the original flags plus: --resume {sticky['run']}"
    print(f"sticky fault (__trap()) after a replayed step of epoch {FENCE_AT[0] + 1}: exit "
          f"{sticky['rc']} {exit_s:.3f} s after the fault (limit {STICKY_EXIT_S:g} s), restores "
          f"{len(sticky['restores'])}, resume line printed {resume_line in sticky['stdout']}, "
          f"{smi}")
    if (sticky["rc"] != recovery.EXIT_CODE or not exit_s <= STICKY_EXIT_S or sticky["restores"]
            or resume_line not in sticky["stdout"] or not sticky.get("replayed")):
        raise AssertionError(f"the sticky fault did not end in exit {recovery.EXIT_CODE} "
                             f"without a restore:\n{sticky['stdout'][-3000:]}\n"
                             f"{sticky['stderr'][-3000:]}")
    resumed = fence_run("cyclegan", "none", cg_argv("cg_resumed", "--resume", sticky["run"]))
    _fence_ok(resumed, "16a's --resume of the sticky run")
    add(resumed)
    print(f"--resume in a fresh process, {smi}: {resumed['first_step'] - resumed['start']:.3f} s "
          "from its start to its first step")
    spread["cyclegan"] = _held("16a's resumed run (epochs 3-4)",
                               fence_diff(resumed["run"], clean["run"], metrics_from=FENCE_EVERY),
                               spread["cyclegan"], clean_again("cyclegan", cg_argv("cg_clean2")))
    for res in (clean, sticky, resumed):
        shutil.rmtree(res["run"])

    phase(f"16b. Pix2Pix at {IMG_SIZE}², batch {FENCE_P2P[0]}, streamed from the files "
          "(--host-cache off): a fault after a replayed step rewinds in-process")
    data = os.path.join(tmp, "pairs")
    write_noise_pngs(data, FENCE_P2P[1], (IMG_SIZE, 2 * IMG_SIZE), SEED + 42)

    def p2p_argv(name):
        return ["--data", data, "--output", os.path.join(tmp, name), "--train", "--epochs",
                str(FENCE_EPOCHS), "--img-size", str(IMG_SIZE), "--batch-size",
                str(FENCE_P2P[0]), "--test-img", "1", "--dtype", "bf16", "--logging", "false",
                "--num-devices", "1", "--checkpoint-every", str(FENCE_EVERY), "--host-cache",
                "off"]

    runs["pix2pix"] = fence_run("pix2pix", "none", p2p_argv("p2p_clean"))
    _fence_ok(runs["pix2pix"], "16b's clean run")
    add(runs["pix2pix"])
    rt = fence_run("pix2pix", "runtime", p2p_argv("p2p_runtime"))
    _fence_ok(rt, "16b's run with a RuntimeError")
    add(rt)
    if not rt.get("replayed") or len(rt["restores"]) != 1:
        raise AssertionError("the fault did not strike a replayed step, or the run did not "
                             "restore once")
    print(f"RuntimeError after a replayed streamed step of epoch {FENCE_AT[0] + 1}, {smi}: "
          f"{rt['after'] - rt['fault']:.3f} s from the fault to the end of the first step "
          f"after the rewind (restore {rt['restores'][0]:.3f} s, capture {rt['capture_s']:.3f} s)")
    _held("16b's rewound run", fence_diff(rt["run"], runs["pix2pix"]["run"]), spread["pix2pix"],
          clean_again("pix2pix", p2p_argv("p2p_clean2")))
    for res in (rt, runs["pix2pix"]):
        shutil.rmtree(res["run"])

    phase("16c. a fault inside a CUDA-graph capture")
    check_capture_faults()
    print(f"phase 16 launches, counted on the card: {launches}")
    if not all(launches.get(name, 0) > 0 for name in SOURCES):
        raise AssertionError("a kernel of phase 16's paths was never launched")
    return launches


def tf32_off() -> None:
    """fp32 convs and matmuls in full fp32, for the fp32 comparisons."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


ADAM_BYTES = 28   # a parameter's update: read p, g, m, v, write p, m, v, fp32
ADAM_CONFIGS = {"pix2pix-512": ("batch", True, 1), "cyclegan-256": ("instance", False, 2)}
# one update against another's fp32 terms: one ulp each way (tests/test_torch_adam.py)
ADAM_ULPS = 2.0


def adam_params(config: str, device) -> list[list[torch.Tensor]]:
    """Seeded parameters of ``config``'s networks on the card, one list a
    network in the trainer's order, each in its model's layout: the U-Net
    (batch norm for Pix2Pix, instance norm for CycleGAN) and the PatchGAN
    (conditional for Pix2Pix), CycleGAN's twice each."""
    from gan_tpu_torch.models.patchgan import PatchGANDiscriminator
    from gan_tpu_torch.models.unet import UNetGenerator
    norm_type, target, copies = ADAM_CONFIGS[config]
    g = torch.Generator().manual_seed(SEED)
    nets = [UNetGenerator(1, 1, norm=norm_type, depth=8, generator=g)] * copies \
        + [PatchGANDiscriminator(1, norm=norm_type, target=target, generator=g)] * copies
    return [[p.detach().to(device, copy=True) for p in net.parameters()] for net in nets]


def _adam_max_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    big = torch.maximum(a.abs(), b.abs())
    return float(((a - b).abs() / (torch.nextafter(big, big + 1) - big)).max())


def _torch_adam(opts, grads) -> None:
    """torch.optim.Adam's own step: a yardstick, never the port's path."""
    for opt, gs in zip(opts, grads):
        for p, g in zip(opt.param_groups[0]["params"], gs):
            p.grad = g
        opt.step()


def _adam_twin(opts, grads) -> None:
    hyper, rows = kernels.adam_rows(opts, grads)
    kernels.adam_update_plain(rows, *hyper)


def check_adam() -> dict:
    """Phase 17. Returns {config: {"ms", "plain_ms", "library_ms",
    "foreach_ms", "bound_ms"}}: the kernel, its plain twin, torch's fused
    Adam (the library kernel for this update), torch's capturable foreach
    Adam (what the port ran before the kernel) and the 28-B bound."""
    from gan_tpu_torch.train.optim import TF_ADAM_EPS, adam
    device = torch.device("cuda")
    lr = 2e-4
    capturable = lambda net: adam(net, lr, capturable=True)
    fused = lambda net: torch.optim.Adam(net, lr=lr, betas=(0.5, 0.999), eps=TF_ADAM_EPS,
                                         capturable=True, fused=True)
    out = {}
    for config in ADAM_CONFIGS:
        params = adam_params(config, device)
        n = sum(p.numel() for ps in params for p in ps)
        gen = torch.Generator(device=device).manual_seed(SEED)
        grads = [[torch.empty_like(p).copy_(torch.randn(p.shape, generator=gen, device=device))
                  .mul_(1e-3) for p in ps] for ps in params]   # in each parameter's layout
        runs = {}
        for label, update in (("kernel", kernels.adam_step), ("plain", _adam_twin),
                              ("foreach", _torch_adam)):
            ps = [[p.clone(memory_format=torch.preserve_format) for p in net] for net in params]
            opts = [capturable(net) for net in ps]
            with torch.no_grad():
                update(opts, grads)   # the kernel's launch error is checked by the wrapper
            torch.cuda.synchronize()
            runs[label] = (opts, ps)
        for label in ("plain", "foreach"):
            gaps = [0.0, 0.0, 0.0]   # p, exp_avg, exp_avg_sq
            (opts_k, params_k), (opts_w, params_w) = runs["kernel"], runs[label]
            for og, ow, pg, pw in zip(opts_k, opts_w, params_k, params_w):
                for a, b in zip(pg, pw):
                    sa, sb = og.state[a], ow.state[b]
                    if not torch.equal(sa["step"], sb["step"]):
                        raise AssertionError(f"{config}: kernel step {sa['step']} vs {label} "
                                             f"{sb['step']}")
                    for i, (x, y) in enumerate(((a, b), (sa["exp_avg"], sb["exp_avg"]),
                                                (sa["exp_avg_sq"], sb["exp_avg_sq"]))):
                        gaps[i] = max(gaps[i], _adam_max_ulps(x, y))
            print(f"{config}: one update, kernel vs {label}: largest gaps in ulps p {gaps[0]:g}, "
                  f"exp_avg {gaps[1]:g}, exp_avg_sq {gaps[2]:g}")
            if max(gaps) > ADAM_ULPS:
                raise AssertionError(f"{config}: kernel vs {label} beyond {ADAM_ULPS} ulps")
        del runs
        t = {}
        for key, update, make in (("ms", kernels.adam_step, capturable),
                                  ("plain_ms", _adam_twin, capturable),
                                  ("library_ms", _torch_adam, fused),
                                  ("foreach_ms", _torch_adam, capturable)):
            opts = [make(net) for net in params]
            with torch.no_grad():
                update(opts, grads)   # the state, made outside the graph
                t[key] = device_ms(lambda: update(opts, grads), calls=10)
            del opts
        t["bound_ms"], _ = bound_ms(ADAM_BYTES * n)
        out[config] = t
        print(f"{config}: {len(params)} networks, {sum(len(ps) for ps in params)} tensors, "
              f"{n:,} parameters: kernel {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
              f"us, torch.optim.Adam(fused=True, capturable=True) {t['library_ms'] * 1e3:.2f} us, "
              f"its foreach form (capturable) {t['foreach_ms'] * 1e3:.2f} us, 28-B bound "
              f"{t['bound_ms'] * 1e3:.2f} us; share of bound {t['bound_ms'] / t['ms']:.1%}, "
              f"kernel/fused {t['ms'] / t['library_ms']:.2f}, kernel/foreach "
              f"{t['ms'] / t['foreach_ms']:.2f}")
        del params, grads
        torch.cuda.empty_cache()
    return out


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
    tf32_off()

    phase("2. build")
    path, seconds = build.build()
    print(f"built {os.path.relpath(path)} in {seconds:.2f} s (0 = reused)")
    with open(path + ".log") as f:
        print("".join(line for line in f if "registers" in line or "spill" in line), end="")
    path, seconds = native.build()
    print(f"built the native PNG decoder {os.path.relpath(path)} with {native.compiler()} in "
          f"{seconds:.2f} s (0 = reused)")

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
          f"{s_step[2] * 1e3:.2f} us, bound {s_step[3] * 1e3:.2f} us (by {s_by}); share of "
          f"bound {s_step[3] / s_step[0]:.1%}, kernel/library {s_step[0] / s_step[2]:.2f}")

    launches = {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    phase("5. CycleGAN predict slice")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_slice(tmp))

    phase(f"6. instance-norm backward kernel (K2) vs plain, training shapes, batch {TRAIN_BATCH}")
    step_sites = sites + list(DISC_NORM_SITES)
    widths = pass_widths(BATCHED_PASSES, TRAIN_BATCH, TRAIN_BATCH)
    b = check_backward(sorted(set(step_sites)), sorted(
        {(n, hw, c) for n in widths if n != TRAIN_BATCH for hw, c in sites}
        | {(2 * TRAIN_BATCH, hw, c) for hw, c in DISC_NORM_SITES}))
    k2_pass = [sum(b["times"][(hw, c, torch.bfloat16)][i] for hw, c in step_sites)
               for i in range(4)]
    print(f"{len(step_sites)} sites of one bf16 generator and one discriminator backward at batch "
          f"{TRAIN_BATCH}: kernel {k2_pass[0] * 1e3:.2f} us, plain {k2_pass[1] * 1e3:.2f} us, "
          f"F.instance_norm backward {k2_pass[2] * 1e3:.2f} us, bound {k2_pass[3] * 1e3:.2f} us; "
          f"share of bound {k2_pass[3] / k2_pass[0]:.1%}, kernel/library "
          f"{k2_pass[0] / k2_pass[2]:.2f}")

    phase(f"7. CycleGAN training slice: fit at {IMG_SIZE}², bf16, batch {TRAIN_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_training(tmp, smi))

    phase(f"9. Pix2Pix predict slice: {IMG_SIZE}², depth 8, bf16, per-image batch norm")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_pix2pix_predict(tmp))

    phase(f"10. Pix2Pix training slice: fit at {IMG_SIZE}², bf16, batch {P2P_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_pix2pix_training(tmp))

    phase("12. quality slice: Inception features, Pix2Pix predictions scored on the card")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_quality(tmp, smi))

    phase("13. host-data slice: training and predict streamed from PNG files")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_host_data(tmp, smi))

    phase(f"14. the {IMG_512}² slice: K1, K2 and S at its sites, fit with --remat off and on, "
          "predict, the remat frontier")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_512(tmp, smi))

    phase("15. data parallelism: NCCL at a world of 1, two gloo ranks on the card, the CLI")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_data_parallel(tmp, smi))

    phase("16. the fault fence: in-process rewinds, a sticky fault's exit 17 and --resume")
    with tempfile.TemporaryDirectory() as tmp:
        add(run_fence(tmp, smi))

    phase("17. Adam's update at both benchmark configurations' parameter lists")
    a = check_adam()

    print(f"\nlaunches on the main paths (phases 5-16), counted on the card: {launches}")
    if not all(launches[name] > 0 for name in SOURCES):
        raise AssertionError("a kernel of the paths was never launched")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
         "bound_ms": t[3], "bound_by": by, "library_ms": t[2]}
        for name, err, t, by in (("instance_norm_fwd", k["max_abs_err"], k1_pass, "bytes"),
                                 ("instance_norm_bwd", b["max_abs_err"], k2_pass, "bytes"),
                                 ("stem_conv", s["max_abs_err"], s_step, s_by))]}
    record["kernels"].append(
        {"name": "adam_update", "route": "cuda", "source": SOURCES["adam_update"],
         "replaces": REPLACES["adam_update"], "launches": launches["adam_update"],
         "bound_by": "bytes", "at": a})
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
