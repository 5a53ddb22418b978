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

On a CPU tensor the wrappers run the plain versions in
:mod:`gan_tpu_torch.ops.norm` and :mod:`gan_tpu_torch.ops.conv`. On CUDA they
launch the kernel or raise; nothing falls back. ``LAUNCHES`` counts kernel
launches by name, so a run can show that its path went through the kernels.

The library is built by :mod:`gan_tpu_torch.ops.build` at first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gan_tpu_torch.ops import build, conv, norm

LAUNCHES = {"instance_norm_fwd": 0, "instance_norm_bwd": 0, "stem_conv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "leaky_relu": 1, "relu": 2}
STEM_CHANNELS = (1, 2, 3, 6)   # C_in of the stems: 1 or 3 channels, doubled by Pix2Pix's D
STEM_FILTERS = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build.build()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gan_instance_norm_fwd.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
    lib.gan_instance_norm_fwd.restype = i
    lib.gan_instance_norm_bwd.argtypes = [p, p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
    lib.gan_instance_norm_bwd.restype = i
    lib.gan_stem_conv.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.gan_stem_conv.restype = i
    return lib


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


def _launch_fwd(x, scale, offset, act, eps) -> torch.Tensor:
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gan_instance_norm_fwd(
            x.data_ptr(), scale.data_ptr(), offset.data_ptr(), y.data_ptr(),
            n, h * w, c, eps, _ACTS[act], _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: cudaError {err}")
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
    dy = dy.contiguous()
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    dscale_part = torch.empty((n, c), dtype=torch.float32, device=x.device)
    doffset_part = torch.empty((n, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gan_instance_norm_bwd(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dscale_part.data_ptr(), doffset_part.data_ptr(),
            n, h * w, c, eps, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"instance_norm backward kernel launch failed: cudaError {err}")
    LAUNCHES["instance_norm_bwd"] += 1
    return dx, dscale_part.sum(dim=0), doffset_part.sum(dim=0)


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
