"""Where the port runs, and in what compute type.

``GAN_TPU_PLATFORM=cpu`` (the knob gan_tpu already reads; the test harness
sets it) selects the CPU. Otherwise the device is CUDA, and the absence of a
card is an error: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

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
