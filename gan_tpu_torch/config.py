"""The CLIs' flags and config.json (counterpart of gan_tpu/config.py).

Stdlib only, so the port parses its flags where jax is absent. Flag names,
defaults, choices, asserts and the ``config.json`` keys are gan_tpu's;
tests/test_torch_predict.py and tests/test_torch_pix2pix.py hold the parsers
against gan_tpu's. ``--dtype`` maps to a torch dtype through
:func:`gan_tpu_torch.device.torch_dtype`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional


def _env_true(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


@dataclasses.dataclass
class BaseConfig:
    """The flags both CLIs share; field order is gan_tpu's."""

    output: str = ""
    img_size: int = 256
    batch_size: int = 1
    buffer_size: int = 99999
    channels: str = "1"          # a string, as in the reference
    logging: str = "true"
    seed: int = 123
    train: bool = False
    predict: bool = False
    save_weights: str = "true"
    epochs: int = 5
    validation_size: float = 0.1
    test_img: int = 5
    learning_rate: float = 2e-4
    beta_1: float = 0.5
    beta_2: float = 0.999
    weights: Optional[str] = None
    # gan_tpu's extensions, parsed for config.json parity
    dtype: str = "bf16"              # compute dtype: bf16 | fp32 (params always fp32)
    device_cache: str = "auto"
    bn_cross_replica: str = "false"
    resume: Optional[str] = None
    num_devices: int = 0
    use_pallas: str = "auto"         # does not select the port's path
    raw_predictions: str = "false"   # also write bare generated PNGs in predict
    remat: str = "auto"
    host_cache: str = "auto"
    checkpoint_every: int = 0

    def validate(self) -> None:
        """gan_tpu's asserts. GAN_TPU_ALLOW_ANY_SIZE=1 allows any power-of-two
        size >= 32 (the tests' small sizes)."""
        if _env_true("GAN_TPU_ALLOW_ANY_SIZE"):
            assert self.img_size >= 32 and (self.img_size & (self.img_size - 1)) == 0, \
                "img-size must be a power of two >= 32"
        else:
            assert self.img_size in (256, 512), \
                "img-size currently only supported for 256 x 256 or 512 x 512 pixels!"
        assert 0.0 < self.validation_size <= 0.3, \
            "validation size is a proportion and bounded between 0-0.3!"
        assert self.test_img >= 1, "test-img is an integer and must be >=1!"
        assert self.channels in ("1", "3")
        assert self.dtype in ("bf16", "fp32")

    @property
    def n_channels(self) -> int:
        return int(self.channels)

    def to_json(self) -> str:
        # the reference's argparse dest for --lambda is "lambda"
        return json.dumps({("lambda" if k == "lam" else k): v
                           for k, v in dataclasses.asdict(self).items()})

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


@dataclasses.dataclass
class Pix2PixConfig(BaseConfig):
    """Pix2Pix flags."""

    data: str = ""
    generator_loss: str = "l1"       # l1 | ssim (gan_tpu's corrected SSIM loss)
    input_img_orient: str = "left"
    lam: int = 100

    def validate(self) -> None:
        super().validate()
        assert self.generator_loss in ("l1", "ssim")
        assert self.input_img_orient in ("left", "right")


@dataclasses.dataclass
class CycleGANConfig(BaseConfig):
    """CycleGAN flags."""

    input_images: str = ""
    target_images: Optional[str] = None
    lam: int = 10


def _add_common(p: argparse.ArgumentParser, argv) -> None:
    p.add_argument("--output", type=str, required=True, help="path to output results")
    p.add_argument("--img-size", type=int, default=256, help="image size h,w")
    p.add_argument("--batch-size", type=int, default=1, help="global batch size")
    p.add_argument("--buffer-size", type=int, default=99999, help="buffer size")
    p.add_argument("--channels", type=str, default="1", choices=["1", "3"],
                   help="number of color channels to read in and output")
    p.add_argument("--logging", type=str, default="true", choices=["true", "false"],
                   help="turn on/off script logging")
    p.add_argument("--seed", type=int, default=123, help="seed value for random number generator")
    group = p.add_mutually_exclusive_group(required=True)
    group.add_argument("--train", action="store_true", help="train model using data")
    group.add_argument("--predict", action="store_true",
                       help="use pretrained weights to make predictions on data")
    p.add_argument("--save-weights", type=str, default="true", choices=["true", "false"],
                   help="save model checkpoints and weights")
    p.add_argument("--epochs", type=int, default=5, required="--train" in argv,
                   help="number of epochs to train")
    p.add_argument("--validation-size", type=float, default=0.1,
                   help="validation set size as share of number of training images")
    p.add_argument("--test-img", type=int, default=5, help="number of test images to sample")
    p.add_argument("--learning-rate", type=float, default=2e-4, help="Adam learning rate")
    p.add_argument("--beta-1", type=float, default=0.5, help="Adam beta_1")
    p.add_argument("--beta-2", type=float, default=0.999, help="Adam beta_2")
    p.add_argument("--weights", type=str, required="--predict" in argv,
                   help="path to pretrained model weights for prediction")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"],
                   help="compute dtype on device (params stay fp32)")
    p.add_argument("--device-cache", type=str, default="auto", choices=["auto", "on", "off"],
                   help="device-resident training caches (auto: when they fit in 0.4 of "
                        "the device's memory; off: stream batches from host memory)")
    p.add_argument("--bn-cross-replica", type=str, default="false", choices=["true", "false"],
                   help="data-parallel training: batch-norm statistics over every "
                        "replica's batch (default: each replica's own)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint directory to resume training from")
    p.add_argument("--num-devices", type=int, default=0,
                   help="number of devices for data parallelism (0 = all)")
    p.add_argument("--use-pallas", type=str, default="auto", choices=["auto", "on", "off"],
                   help="gan_tpu's Pallas switch; parsed, the port always runs its CUDA kernels")
    p.add_argument("--raw-predictions", type=str, default="false", choices=["true", "false"],
                   help="in predict mode, also write bare generated images "
                        "(prediction_images_raw/)")
    p.add_argument("--remat", type=str, default="auto", choices=["auto", "on", "off"],
                   help="gradient checkpointing of the U-Net blocks in training (auto: "
                        "only where training would not fit in the device's memory)")
    p.add_argument("--host-cache", type=str, default="auto", choices=["auto", "on", "off"],
                   help="host-RAM data cache (auto: when the decoded corpus fits in half "
                        "of MemAvailable; off: stream batches from the image files)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N epochs (0 = only the reference's cadence)")


def parse_pix2pix(argv=None) -> Pix2PixConfig:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser("pix2pix")
    p.add_argument("--data", type=str, required=True, help="path to data")
    p.add_argument("--generator-loss", type=str, default="l1", choices=["l1", "ssim"],
                   help="combined generator loss function")
    p.add_argument("--input-img-orient", type=str, default="left", choices=["left", "right"],
                   help="whether input image is on left (i.e. target right) or vice-versa")
    p.add_argument("--lambda", dest="lam", type=int, default=100,
                   help="lambda value for secondary generator loss")
    _add_common(p, argv)
    cfg = Pix2PixConfig(**vars(p.parse_args(argv)))
    cfg.validate()
    return cfg


def parse_cyclegan(argv=None) -> CycleGANConfig:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser("cycle_gan")
    p.add_argument("--input-images", type=str, required=True, help="path to input images")
    p.add_argument("--target-images", type=str, required="--train" in argv,
                   help="path to target images")
    p.add_argument("--lambda", dest="lam", type=int, default=10, help="lambda parameter value")
    _add_common(p, argv)
    cfg = CycleGANConfig(**vars(p.parse_args(argv)))
    cfg.validate()
    return cfg
