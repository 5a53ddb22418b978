"""Wrappers of the port's hand-written CUDA kernels.

``instance_norm`` launches ``gan_tpu_torch/csrc/instance_norm.cu`` (the CUDA
port of gan_tpu/ops/pallas_kernels.py:_in_fwd_kernel, K1 with its K3
activation epilogue) on a CUDA tensor, and runs the plain version in
:mod:`gan_tpu_torch.ops.norm` on a CPU tensor. On CUDA it launches the kernel
or raises; nothing falls back. ``LAUNCHES`` counts kernel launches by name,
so a run can show that its path went through the kernels.

The library is built by :mod:`gan_tpu_torch.ops.build` at first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gan_tpu_torch.ops import build, norm

LAUNCHES = {"instance_norm_fwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {None: 0, "leaky_relu": 1, "relu": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build.build()
    lib = ctypes.CDLL(path)
    p = ctypes.c_void_p
    lib.gan_instance_norm_fwd.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_float,
                                          ctypes.c_int, ctypes.c_int, p]
    lib.gan_instance_norm_fwd.restype = ctypes.c_int
    return lib


def _check_instance_norm(x, scale, offset, act) -> None:
    if x.dim() != 4:
        raise ValueError(f"instance_norm takes NHWC (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"instance_norm takes a contiguous NHWC tensor, got strides {x.stride()}")
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of {tuple(_ACTS)}")
    c = x.shape[-1]
    for name, t in (("scale", scale), ("offset", offset)):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.numel() == 0:
        raise ValueError("instance_norm of an empty tensor")


def instance_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor, *,
                  act: str | None = None) -> torch.Tensor:
    """Fused per-(sample, channel) normalization over (H, W) of an NHWC
    tensor, with the activation epilogue ``act`` (None, 'leaky_relu' or
    'relu'). Forward only: the backward kernel (K2) is not ported yet."""
    _check_instance_norm(x, scale, offset, act)
    if x.device.type == "cpu":
        return norm.instance_norm(x, scale, offset, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm runs on cpu or cuda, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or offset.requires_grad):
        raise NotImplementedError(
            "instance_norm on CUDA is forward-only: the backward kernel "
            "(K2, gan_tpu/ops/pallas_kernels.py:_in_bwd_kernel) is not ported "
            "yet; run under torch.no_grad()")
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
