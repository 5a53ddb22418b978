"""Where the port runs, and in what compute type.

``GAN_TPU_PLATFORM=cpu`` (the knob gan_tpu already reads; the test harness
sets it) selects the CPU. Otherwise the device is CUDA, and the absence of a
card is an error: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import contextlib
import os

import torch

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def default_device() -> torch.device:
    if os.environ.get("GAN_TPU_PLATFORM", "").startswith("cpu"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set GAN_TPU_PLATFORM=cpu "
                           "to run gan_tpu_torch on the CPU")
    return torch.device("cuda")


def torch_dtype(name: str) -> torch.dtype:
    """``--dtype`` (bf16 | fp32) as a torch dtype. Parameters stay fp32."""
    return _DTYPES[name]


@contextlib.contextmanager
def no_tf32():
    """fp32 convs and matmuls in full fp32 inside the block: on the card cuDNN's
    convs default to TF32, which would make a result depend on the device."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
