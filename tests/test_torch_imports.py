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
from torch_inputs import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax_orbax_pil_matplotlib():
    """Nor gan_tpu: the port and chip_smoke.py run without the JAX package beside them."""
    code = (
        "import sys\n"
        "import gan_tpu_torch, gan_tpu_torch.cycle_gan, gan_tpu_torch.transplant\n"
        "import gan_tpu_torch.train.cyclegan_trainer, gan_tpu_torch.ops.kernels\n"
        "import gan_tpu_torch.data.pipeline, gan_tpu_torch.data.loader, gan_tpu_torch.utils\n"
        "import gan_tpu_torch.models.patchgan, gan_tpu_torch.losses, gan_tpu_torch.ops.loss_ops\n"
        "import gan_tpu_torch.train.optim, gan_tpu_torch.train.loop, gan_tpu_torch.utils.figs\n"
        "import gan_tpu_torch.pix2pix, gan_tpu_torch.train.pix2pix_trainer, gan_tpu_torch.ops.ssim\n"
        "import gan_tpu_torch.train.base, gan_tpu_torch.data.augment, gan_tpu_torch.data.split\n"
        "import gan_tpu_torch.models.inception, gan_tpu_torch.quality\n"
        "import gan_tpu_torch.tools.eval_quality, gan_tpu_torch.data.native\n"
        "import gan_tpu_torch.parallel, gan_tpu_torch.parallel.mesh\n"
        "import gan_tpu_torch.train.recovery, gan_tpu_torch.train.checkpoint\n"
        "import gan_tpu_torch.pix2pixhd, gan_tpu_torch.train.pix2pixhd_trainer\n"
        "import gan_tpu_torch.models.resnet_generator, gan_tpu_torch.models.multiscale_d\n"
        "import gan_tpu_torch.models.vgg, gan_tpu_torch.data.labels\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'PIL', 'matplotlib',\n"
        "                                    'gan_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_decoder_includes_only_zlib_and_the_standard_library():
    """The card's machine has zlib's headers but not libpng's or libjpeg's."""
    with open(os.path.join(REPO, "gan_tpu_torch", "data", "native", "decoder.cpp")) as f:
        includes = [line.split()[1] for line in f if line.startswith("#include")]
    assert "<zlib.h>" in includes
    assert not {"<png.h>", "<jpeglib.h>"} & set(includes)
    assert all(h == "<zlib.h>" or not h.endswith('.h>') for h in includes), includes


def test_native_build_without_a_compiler_raises_and_names_the_switch(tmp_path):
    """With ``CXX`` naming a missing program the first decode raises a build
    error that names ``GAN_TPU_NATIVE=0``; nothing falls back to PIL."""
    png = tmp_path / "x.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n")
    code = (
        "import sys\n"
        "from gan_tpu_torch.data import native, pipeline\n"
        "try:\n"
        f"    pipeline.build_cyclegan_cache([{str(png)!r}], img_size=8, channels=1)\n"
        "except native.NativeBuildError as e:\n"
        "    print(e)\n"
        "    sys.exit(3)\n")
    env = dict(os.environ, CXX=str(tmp_path / "no-such-compiler"))
    env.pop("GAN_TPU_NATIVE", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "GAN_TPU_NATIVE=0" in proc.stdout and "no-such-compiler" in proc.stdout


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


@pytest.mark.parametrize("case", ["c_in_4", "filters_32", "odd_h", "float16", "non_contiguous"])
def test_stem_wrapper_refuses_what_the_kernel_does_not_take(case):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 2)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.standard_normal((64, 2, 4, 4))).astype(np.float32))
    kw = {}
    if case == "c_in_4":
        x, w = torch.cat([x, x], -1), torch.cat([w, w], 1)
    elif case == "filters_32":
        w = w[:32]
    elif case == "odd_h":
        x = x[:, :7].contiguous()
    elif case == "float16":
        kw["compute_dtype"] = torch.float16
    elif case == "non_contiguous":
        x = x.permute(0, 2, 1, 3)
    with pytest.raises((ValueError, TypeError)):
        kernels.stem_conv(x, w, **kw)
