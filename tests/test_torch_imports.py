"""What the port imports, where it runs, and what its kernel wrapper refuses.

The machine with the card has no jax or orbax and may lack Pillow and
matplotlib, so neither the package nor chip_smoke.py may import them."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gan_tpu_torch.config import parse_cyclegan
from gan_tpu_torch import device
from gan_tpu_torch.ops import kernels
from gan_tpu_torch.train.cyclegan_trainer import CycleGANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax_orbax_pil_matplotlib():
    """Nor gan_tpu: the port and chip_smoke.py run without the JAX package beside them."""
    code = (
        "import sys\n"
        "import gan_tpu_torch, gan_tpu_torch.cycle_gan, gan_tpu_torch.transplant\n"
        "import gan_tpu_torch.train.cyclegan_trainer, gan_tpu_torch.ops.kernels\n"
        "import gan_tpu_torch.data.pipeline, gan_tpu_torch.utils\n"
        "import gan_tpu_torch.models.patchgan, gan_tpu_torch.losses, gan_tpu_torch.ops.loss_ops\n"
        "import gan_tpu_torch.train.optim, gan_tpu_torch.train.loop, gan_tpu_torch.utils.figs\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'PIL', 'matplotlib',\n"
        "                                    'gan_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_selection_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("GAN_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.default_device()
    cfg = parse_cyclegan(["--input-images", "x", "--output", "o", "--predict", "--weights", "w",
                          "--img-size", "32"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CycleGANTrainer(cfg)
    monkeypatch.setenv("GAN_TPU_PLATFORM", "cpu")
    assert device.default_device() == torch.device("cpu")


def test_torch_dtype():
    assert device.torch_dtype("bf16") is torch.bfloat16
    assert device.torch_dtype("fp32") is torch.float32


def _args(shape=(2, 4, 4, 64), dtype=torch.float32):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    return x.to(dtype), torch.ones(shape[-1]), torch.zeros(shape[-1])


@pytest.mark.parametrize("case", ["non_contiguous", "float16", "float64", "3d",
                                  "scale_bf16", "scale_shape", "act"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, scale, offset = _args()
    kw = {}
    if case == "non_contiguous":
        x = x.permute(0, 2, 1, 3)          # NHWC strides broken
    elif case == "float16":
        x = x.half()
    elif case == "float64":
        x = x.double()
    elif case == "3d":
        x = x[0]
    elif case == "scale_bf16":
        scale = scale.bfloat16()
    elif case == "scale_shape":
        offset = torch.zeros(32)
    elif case == "act":
        kw["act"] = "gelu"
    with pytest.raises((ValueError, TypeError)):
        kernels.instance_norm(x, scale, offset, **kw)
