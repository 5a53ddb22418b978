"""Wrappers of the port's hand-written CUDA kernels.

``gan_tpu_torch/csrc/instance_norm.cu`` holds the CUDA ports of
gan_tpu/ops/pallas_kernels.py:_in_fwd_kernel (K1, with its K3 activation
epilogue) and :_in_bwd_kernel (K2). ``instance_norm`` launches K1 on a CUDA
tensor; where a gradient is needed it goes through ``InstanceNormFunction``,
whose backward launches K2 (``instance_norm_backward``), as gan_tpu's
``custom_vjp`` pairs the two.

``gan_tpu_torch/csrc/stem_conv.cu`` holds the CUDA port of
benchmarks/pallas_stem_proto.py:_stem_kernel (S), the fused 4x4 stride-2 conv
and LeakyReLU of every network's first block. ``stem_conv`` launches it; its
gradient (``StemConvFunction``) masks dy with the LeakyReLU's slope and hands
the conv's dx and dw to cuDNN, as XLA took them for gan_tpu.

K1 and K2 split H·W over a thread-block cluster; :func:`norm_plan` chooses
the geometry of each launch from the shape, and the kernels take it as
arguments (the CPU tests hold it at every site of the paths).

On a CPU tensor the wrappers run the plain versions in
:mod:`gan_tpu_torch.ops.norm` and :mod:`gan_tpu_torch.ops.conv`. On CUDA they
launch the kernel or raise; nothing falls back. ``LAUNCHES`` counts kernel
launches by name, so a run can show that its path went through the kernels.

The library is built by :mod:`gan_tpu_torch.ops.build` at first use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gan_tpu_torch.ops import build, conv, norm

LAUNCHES = {"instance_norm_fwd": 0, "instance_norm_bwd": 0, "stem_conv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "leaky_relu": 1, "relu": 2}
STEM_CHANNELS = (1, 2, 3, 6)   # C_in of the stems: 1 or 3 channels, doubled by Pix2Pix's D
STEM_FILTERS = 64

# K1/K2 launch geometry; csrc/instance_norm.cu holds the same constants
MAX_THREADS = 256         # threads per block; small bands take fewer
MAX_CLUSTER = 16          # blocks per cluster; above 8 is non-portable
PORTABLE_CLUSTER = 8
MAX_SMEM = 232_448        # dynamic shared memory a block may use on Hopper (227 KB)
SMEM_BUDGET = MAX_SMEM // 2 - 1024   # two blocks to an SM (the system keeps 1 KB per block)
TARGET_BLOCKS = 256       # about two blocks per SM of the H100's 132
MIN_BAND_BYTES = 16_384   # split H·W no finer than this per block
MIN_SEG_BYTES = 64        # narrow a channel tile no further than 64-byte rows


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build.build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    plan = [i] * 7   # threads, k, channel tile, rows, vec, staged, smem bytes
    lib.gan_instance_norm_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, *plan, p]
    lib.gan_instance_norm_fwd.restype = i
    lib.gan_instance_norm_bwd.argtypes = [p, p, p, p, p, p, i, i, i, ctypes.c_float, i, *plan, p]
    lib.gan_instance_norm_bwd.restype = i
    lib.gan_instance_norm_max_clusters.argtypes = [i] * 9
    lib.gan_instance_norm_max_clusters.restype = i
    lib.gan_instance_norm_trace.argtypes = [p]
    lib.gan_instance_norm_trace.restype = i
    lib.gan_stem_conv.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.gan_stem_conv.restype = i
    return lib


class NormPlan(NamedTuple):
    """Geometry of one K1 or K2 launch. A cluster of ``k`` blocks owns one
    (sample, tile of ``channel_tile`` channels); each block holds a band of
    ``rows_per_block`` rows of H·W with ``threads`` threads, loads ``vec``
    channels at a time (16 bytes, or 1 where C is not a multiple of that),
    and stages ``staged`` tensors' bands in ``smem_bytes`` of dynamic shared
    memory (K1: x; K2: x, and dy where both fit)."""
    k: int
    channel_tile: int
    rows_per_block: int
    smem_bytes: int
    vec: int
    staged: int
    threads: int
    tiles: int
    blocks: int

    @property
    def portable(self) -> bool:
        return self.k <= PORTABLE_CLUSTER


def _plan_smem(backward: bool, threads: int, k: int, ct: int, rows: int, staged: int,
               elt: int) -> int:
    """Bytes of csrc/instance_norm.cu's layout: the staged bands, then, in
    fp32 and ct wide, two rows per warp and a row per block of the cluster
    per sum exchanged (2, or 4 in K2)."""
    return staged * rows * ct * elt + 4 * (2 * (threads // 32) + (4 if backward else 2) * k) * ct


def _threads(rows: int, lanes: int) -> int:
    """One row of the band per row thread where it has few rows, in whole
    warps, at most MAX_THREADS."""
    return min(MAX_THREADS, max(32, 1 << (rows * lanes - 1).bit_length()))


def make_plan(n: int, hw: int, c: int, dtype: torch.dtype, k: int, ct: int, vec: int, *,
              backward: bool = False) -> NormPlan:
    """The plan of ``k`` blocks per cluster and ``ct``-channel tiles: rows
    per band, and what is staged in shared memory (none where ``vec`` is 1:
    cp.async copies 16 bytes). K2 stages dy's band beside x's where both fit
    in SMEM_BUDGET, else x's alone."""
    elt = torch.finfo(dtype).bits // 8
    rows = -(-hw // k)
    threads = _threads(rows, ct // vec)
    staged = 0
    if vec > 1:
        limits = ((2, SMEM_BUDGET), (1, MAX_SMEM)) if backward else ((1, MAX_SMEM),)
        staged = next((s for s, limit in limits
                       if _plan_smem(backward, threads, k, ct, rows, s, elt) <= limit), 0)
    tiles = -(-c // ct)
    return NormPlan(k, ct, rows, _plan_smem(backward, threads, k, ct, rows, staged, elt), vec,
                    staged, threads, tiles, n * tiles * k)


@functools.cache
def norm_plan(n: int, hw: int, c: int, dtype: torch.dtype, *, backward: bool = False,
              aligned: bool = True) -> NormPlan:
    """The launch geometry of K1 (or K2, ``backward``) on an (n, H·W, c)
    tensor. Channel tiles start as 128-byte row segments (all of C where C
    is narrower). While the launch has fewer than TARGET_BLOCKS blocks, it
    splits H·W over up to 8 blocks, then narrows the tiles to 64-byte rows,
    then splits up to 16, keeping bands of at least MIN_BAND_BYTES; then it
    splits or narrows further until x's band fits in SMEM_BUDGET, two blocks
    to an SM. K2 takes K1's geometry, so its statistics are the forward's
    bit for bit. ``aligned``: every tensor's address is a multiple of 16
    bytes."""
    elt = torch.finfo(dtype).bits // 8
    wide = 16 // elt
    vec = wide if aligned and c % wide == 0 else 1
    ct = 32 if vec == 1 else min(128 // elt, vec * (1 << (c // vec - 1).bit_length()))

    def band(k_, ct_):
        return -(-hw // k_) * ct_ * elt

    def narrower(ct_):   # a halved tile that still loads 16 bytes and adds tiles
        return (vec > 1 and ct_ * elt > MIN_SEG_BYTES and ct_ // 2 >= vec
                and -(-c // (ct_ // 2)) > -(-c // ct_))

    k = 1
    while n * -(-c // ct) * k < TARGET_BLOCKS:
        if k < PORTABLE_CLUSTER and band(2 * k, ct) >= MIN_BAND_BYTES:
            k *= 2
        elif narrower(ct) and band(k, ct // 2) >= MIN_BAND_BYTES:
            ct //= 2
        elif k < MAX_CLUSTER and band(2 * k, ct) >= MIN_BAND_BYTES:
            k *= 2
        else:
            break
    while vec > 1 and _plan_smem(False, MAX_THREADS, k, ct, -(-hw // k), 1, elt) > SMEM_BUDGET:
        if k < MAX_CLUSTER:
            k *= 2
        elif narrower(ct):
            ct //= 2
        else:
            break
    return make_plan(n, hw, c, dtype, k, ct, vec, backward=backward)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def max_active_clusters(plan: NormPlan, n: int, c: int, dtype: torch.dtype,
                        backward: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a K1 (or K2) launch with ``plan``
    on the current card."""
    got = _lib().gan_instance_norm_max_clusters(int(backward), n, c, _DTYPES[dtype], plan.threads,
                                                plan.k, plan.channel_tile, plan.vec,
                                                plan.smem_bytes)
    if got < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError {-got} ({plan})")
    return got


def norm_timeline(fn, plan: NormPlan, device) -> torch.Tensor:
    """Run ``fn`` (one K1 or K2 launch with ``plan``) with the kernels'
    per-block timeline on: an int64 (blocks, 16) tensor of clock64() at
    csrc/instance_norm.cu's trace points, the global timer (ns) at the start
    (column 14) and end (13), and the SM (15)."""
    def trace(ptr):
        err = _lib().gan_instance_norm_trace(ptr)
        if err != 0:
            raise RuntimeError(f"setting the instance_norm timeline failed: cudaError {err}")

    buf = torch.zeros((plan.blocks, 16), dtype=torch.int64, device=device)
    trace(buf.data_ptr())
    try:
        fn()
        torch.cuda.synchronize(device)
    finally:
        trace(None)
    return buf


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"instance_norm takes NHWC (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"instance_norm takes a contiguous NHWC tensor, got strides {x.stride()}")
    if x.numel() == 0:
        raise ValueError("instance_norm of an empty tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"instance_norm runs on cpu or cuda, got {x.device}")


def _check_channel_params(x: torch.Tensor, **params: torch.Tensor) -> None:
    c = x.shape[-1]
    for name, t in params.items():
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _plan_args(plan: NormPlan) -> tuple[int, ...]:
    return (plan.threads, plan.k, plan.channel_tile, plan.rows_per_block, plan.vec, plan.staged,
            plan.smem_bytes)


def _launch_fwd(x, scale, offset, act, eps, plan: NormPlan | None = None) -> torch.Tensor:
    """K1; ``plan`` overrides :func:`norm_plan` (for measuring other plans)."""
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    plan = plan or norm_plan(n, h * w, c, x.dtype, aligned=_aligned(x))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gan_instance_norm_fwd(
            x.data_ptr(), scale.data_ptr(), offset.data_ptr(), y.data_ptr(),
            n, h * w, c, eps, _ACTS[act], _DTYPES[x.dtype], *_plan_args(plan), stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: cudaError {err} ({plan})")
    LAUNCHES["instance_norm_fwd"] += 1
    return y


class InstanceNormFunction(torch.autograd.Function):
    """K1 forward, K2 backward (gan_tpu's ``custom_vjp`` at
    pallas_kernels.py:176-191). CUDA tensors only; x is saved, and the
    backward recomputes the statistics from it, as the Pallas backward does."""

    @staticmethod
    def forward(ctx, x, scale, offset, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch_fwd(x, scale, offset, None, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return *instance_norm_backward(x, scale, dy, eps=ctx.eps), None


def instance_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, *,
                  act: str | None = None, eps: float = norm.IN_EPS) -> torch.Tensor:
    """Fused per-(sample, channel) normalization over (H, W) of an NHWC
    tensor, with the activation epilogue ``act`` (None, 'leaky_relu' or
    'relu'). ``eps`` is instance norm's 1e-5, or batch norm's 1e-3 where it
    normalises one image at a time. Differentiable with ``act=None``: on CUDA
    the backward is K2. The epilogue has no backward kernel yet, so on CUDA
    ``act`` with a gradient raises."""
    _check_x(x)
    _check_channel_params(x, scale=scale, offset=offset)
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {tuple(_ACTS)}")
    if x.device.type == "cpu":
        return norm.instance_norm(x, scale, offset, act=act, eps=eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or offset.requires_grad):
        if act is not None:
            raise NotImplementedError(
                "instance_norm's activation epilogue has no backward kernel yet; "
                "apply the activation after the norm, or run under torch.no_grad()")
        return InstanceNormFunction.apply(x, scale, offset, eps)
    return _launch_fwd(x, scale, offset, act, eps)


def instance_norm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                           eps: float = norm.IN_EPS):
    """(dx, dscale, doffset) of ``instance_norm(x, scale, offset)`` (act None)
    for the output gradient ``dy``: K2 on CUDA, the plain version on the CPU.
    ``dy`` must have x's shape and dtype; a strided ``dy`` (autograd hands the
    norm a slice of ``cat``'s gradient) is copied to NHWC first."""
    _check_x(x)
    _check_channel_params(x, scale=scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"dy must match x: got {dy.dtype} {tuple(dy.shape)} on {dy.device}, "
                        f"x is {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return norm.instance_norm_backward(x, scale, dy, eps=eps)
    return _launch_bwd(x, scale, dy.contiguous(), eps)


def _launch_bwd(x, scale, dy, eps, plan: NormPlan | None = None):
    """K2; ``plan`` overrides :func:`norm_plan` (for measuring other plans)."""
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    parts = torch.empty((2, n, c), dtype=torch.float32, device=x.device)   # dscale, doffset
    plan = plan or norm_plan(n, h * w, c, x.dtype, backward=True, aligned=_aligned(x, dy))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gan_instance_norm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(),
            n, h * w, c, eps, _DTYPES[x.dtype], *_plan_args(plan), stream)
    if err != 0:
        raise RuntimeError(f"instance_norm backward kernel launch failed: cudaError {err} ({plan})")
    LAUNCHES["instance_norm_bwd"] += 1
    dscale, doffset = parts.sum(dim=1)   # one reduction over N for both
    return dx, dscale, doffset


def _check_stem(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dim() != 4 or x.shape[-1] not in STEM_CHANNELS:
        raise ValueError(f"stem_conv takes NHWC (N, H, W, C_in) with C_in in {STEM_CHANNELS}, "
                         f"got shape {tuple(x.shape)}")
    n, h, wd, c = x.shape
    if n == 0 or h == 0 or h % 2 or wd % 2:
        raise ValueError(f"stem_conv takes a non-empty input of even H and W, got {tuple(x.shape)}")
    if tuple(w.shape) != (STEM_FILTERS, c, 4, 4):
        raise ValueError(f"stem_conv takes a ({STEM_FILTERS}, {c}, 4, 4) weight, "
                         f"got {tuple(w.shape)}")
    if dtype not in _DTYPES:
        raise TypeError(f"stem_conv computes in float32 or bfloat16, got {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"stem_conv takes a contiguous NHWC tensor, got strides {x.stride()}")
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise ValueError(f"stem_conv runs on cpu or cuda with x and w together, "
                         f"got {x.device} and {w.device}")


def _launch_stem(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """S on a contiguous NHWC ``x`` and an OIHW ``w`` of x's dtype in
    channels-last memory, which is the OHWI array the kernel reads."""
    n, h, wd, c = x.shape
    y = torch.empty((n, h // 2, wd // 2, STEM_FILTERS), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gan_stem_conv(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c,
                                   _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"stem_conv kernel launch failed: cudaError {err}")
    LAUNCHES["stem_conv"] += 1
    return y


class StemConvFunction(torch.autograd.Function):
    """S forward; the backward masks dy with the LeakyReLU's derivative and
    takes the conv's gradients from cuDNN (``aten.convolution_backward``).
    The slope is positive, so y's sign is the pre-activation's, and y = 0
    takes the identity branch, as ``where(z >= 0, ...)`` does. CUDA tensors
    only; x, w and y are saved."""

    @staticmethod
    def forward(ctx, x, w):
        y = _launch_stem(x, w)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        dz = torch.where(y >= 0, dy, dy * norm.LEAKY_SLOPE)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dz.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [2, 2], [1, 1], [1, 1],
            False, [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return (None if dx is None else dx.permute(0, 2, 3, 1).contiguous()), dw


def stem_conv(x: torch.Tensor, w: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """LeakyReLU(0.3) of the 4x4 stride-2 'same' conv of an NHWC ``x`` with
    the OIHW weight ``w`` (64 filters), in ``compute_dtype`` (x's dtype when
    None): S on CUDA, :func:`gan_tpu_torch.ops.conv.stem_conv` on the CPU.
    Differentiable in x and w."""
    dtype = compute_dtype if compute_dtype is not None else x.dtype
    _check_stem(x, w, dtype)
    if x.device.type == "cpu":
        return conv.stem_conv(x, w, compute_dtype=compute_dtype)
    # the models keep conv weights channels-last already: no copy there
    x, w = x.to(dtype), w.to(dtype).contiguous(memory_format=torch.channels_last)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return StemConvFunction.apply(x, w)
    return _launch_stem(x, w)
