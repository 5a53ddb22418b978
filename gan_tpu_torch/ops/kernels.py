"""Wrappers of the port's hand-written CUDA kernels.

``gan_tpu_torch/csrc/instance_norm.cu`` holds the CUDA ports of
gan_tpu/ops/pallas_kernels.py:_in_fwd_kernel (K1, with its K3 activation
epilogue) and :_in_bwd_kernel (K2). ``instance_norm`` launches K1 on a CUDA
tensor; where a gradient is needed it goes through ``InstanceNormFunction``,
whose backward launches K2 (``instance_norm_backward``), as gan_tpu's
``custom_vjp`` pairs the two. On a CPU tensor the wrappers run the plain
versions in :mod:`gan_tpu_torch.ops.norm`. On CUDA they launch the kernel or
raise; nothing falls back. ``LAUNCHES`` counts kernel launches by name, so a
run can show that its path went through the kernels.

The library is built by :mod:`gan_tpu_torch.ops.build` at first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gan_tpu_torch.ops import build, norm

LAUNCHES = {"instance_norm_fwd": 0, "instance_norm_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "leaky_relu": 1, "relu": 2}


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


def _launch_fwd(x, scale, offset, act) -> torch.Tensor:
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gan_instance_norm_fwd(
            x.data_ptr(), scale.data_ptr(), offset.data_ptr(), y.data_ptr(),
            n, h * w, c, norm.IN_EPS, _ACTS[act], _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: cudaError {err}")
    LAUNCHES["instance_norm_fwd"] += 1
    return y


class InstanceNormFunction(torch.autograd.Function):
    """K1 forward, K2 backward (gan_tpu's ``custom_vjp`` at
    pallas_kernels.py:176-191). CUDA tensors only; x is saved, and the
    backward recomputes the statistics from it, as the Pallas backward does."""

    @staticmethod
    def forward(ctx, x, scale, offset):
        ctx.save_for_backward(x, scale)
        return _launch_fwd(x, scale, offset, None)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return instance_norm_backward(x, scale, dy)


def instance_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, *,
                  act: str | None = None) -> torch.Tensor:
    """Fused per-(sample, channel) normalization over (H, W) of an NHWC
    tensor, with the activation epilogue ``act`` (None, 'leaky_relu' or
    'relu'). Differentiable with ``act=None``: on CUDA the backward is K2. The
    epilogue has no backward kernel yet, so on CUDA ``act`` with a gradient
    raises."""
    _check_x(x)
    _check_channel_params(x, scale=scale, offset=offset)
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {tuple(_ACTS)}")
    if x.device.type == "cpu":
        return norm.instance_norm(x, scale, offset, act=act)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or offset.requires_grad):
        if act is not None:
            raise NotImplementedError(
                "instance_norm's activation epilogue has no backward kernel yet; "
                "apply the activation after the norm, or run under torch.no_grad()")
        return InstanceNormFunction.apply(x, scale, offset)
    return _launch_fwd(x, scale, offset, act)


def instance_norm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor):
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
        return norm.instance_norm_backward(x, scale, dy)
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
            n, h * w, c, norm.IN_EPS, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"instance_norm backward kernel launch failed: cudaError {err}")
    LAUNCHES["instance_norm_bwd"] += 1
    return dx, dscale_part.sum(dim=0), doffset_part.sum(dim=0)
