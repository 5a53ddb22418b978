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


class RunChecks:
    """The run flags' checks and ``config.json``, for every CLI's config."""

    def validate(self) -> None:
        assert 0.0 < self.validation_size <= 0.3, \
            "validation size is a proportion and bounded between 0-0.3!"
        assert self.test_img >= 1, "test-img is an integer and must be >=1!"
        assert self.dtype in ("bf16", "fp32")

    def to_json(self) -> str:
        # the reference's argparse dest for --lambda is "lambda"
        return json.dumps({("lambda" if k == "lam" else k): v
                           for k, v in dataclasses.asdict(self).items()})

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


@dataclasses.dataclass
class BaseConfig(RunChecks):
    """The flags the U-Net CLIs share; field order is gan_tpu's."""

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
        super().validate()
        assert self.channels in ("1", "3")

    @property
    def n_channels(self) -> int:
        return int(self.channels)


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


def _add_run_flags(p: argparse.ArgumentParser, argv) -> None:
    """The flags of a run, which every CLI takes under these names."""
    p.add_argument("--output", type=str, required=True, help="path to output results")
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
    p.add_argument("--weights", type=str, required="--predict" in argv,
                   help="path to pretrained model weights for prediction")
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"],
                   help="compute dtype on device (params stay fp32)")
    p.add_argument("--device-cache", type=str, default="auto", choices=["auto", "on", "off"],
                   help="device-resident training caches (auto: when they fit in 0.4 of "
                        "the device's memory; off: stream batches from host memory)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint directory to resume training from")
    p.add_argument("--host-cache", type=str, default="auto", choices=["auto", "on", "off"],
                   help="host-RAM data cache (auto: when the decoded corpus fits in half "
                        "of MemAvailable; off: stream batches from the image files)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N epochs (0 = only the reference's cadence)")


def _add_common(p: argparse.ArgumentParser, argv) -> None:
    """The run flags and the flags both U-Net CLIs share."""
    _add_run_flags(p, argv)
    p.add_argument("--img-size", type=int, default=256, help="image size h,w")
    p.add_argument("--batch-size", type=int, default=1, help="global batch size")
    p.add_argument("--buffer-size", type=int, default=99999, help="buffer size")
    p.add_argument("--channels", type=str, default="1", choices=["1", "3"],
                   help="number of color channels to read in and output")
    p.add_argument("--learning-rate", type=float, default=2e-4, help="Adam learning rate")
    p.add_argument("--beta-1", type=float, default=0.5, help="Adam beta_1")
    p.add_argument("--beta-2", type=float, default=0.999, help="Adam beta_2")
    p.add_argument("--bn-cross-replica", type=str, default="false", choices=["true", "false"],
                   help="data-parallel training: batch-norm statistics over every "
                        "replica's batch (default: each replica's own)")
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


@dataclasses.dataclass
class Pix2PixHDConfig(RunChecks):
    """pix2pixHD's flags (NVIDIA/pix2pixHD options/base_options.py and
    train_options.py, ``label2city_512p`` defaults) under their own names,
    beside the port's run flags. ``--lr``, ``--beta1`` and ``--batchSize``
    fill ``learning_rate``, ``beta_1`` and ``batch_size``, the names the
    trainers share; Adam's beta_2 is pix2pixHD's fixed 0.999. The run
    fields repeat ``BaseConfig``'s, whose order is gan_tpu's config.json."""

    dataroot: str = ""
    output: str = ""
    train: bool = False
    predict: bool = False
    phase: Optional[str] = None      # train_* or test_* folders; default by mode
    load_size: int = 1024            # --loadSize: the width rows are scaled to
    batch_size: int = 1
    label_nc: int = 35
    ngf: int = 64
    n_downsample_global: int = 4
    n_blocks_global: int = 9
    num_D: int = 2
    n_layers_D: int = 3
    ndf: int = 64
    lambda_feat: float = 10.0
    no_vgg_loss: bool = False
    no_ganFeat_loss: bool = False
    no_instance: bool = False
    no_flip: bool = False
    vgg_weights: Optional[str] = None
    learning_rate: float = 2e-4
    beta_1: float = 0.5
    beta_2: float = 0.999
    epochs: int = 5
    seed: int = 123
    dtype: str = "bf16"
    validation_size: float = 0.1
    test_img: int = 5
    logging: str = "true"
    save_weights: str = "true"
    weights: Optional[str] = None
    resume: Optional[str] = None
    checkpoint_every: int = 0
    device_cache: str = "auto"
    host_cache: str = "auto"

    channels = "3"   # the images' channels, as the other configurations name them

    def validate(self) -> None:
        assert 1 <= self.label_nc <= 256, "label_nc is between 1 and 256 (uint8 label ids)"
        assert self.batch_size >= 1 and self.ngf >= 1 and self.ndf >= 1
        assert self.n_downsample_global >= 1 and self.num_D >= 1 and self.n_layers_D >= 1
        assert self.load_size % (1 << self.n_downsample_global) == 0, \
            "loadSize must be a multiple of 2^n_downsample_global"
        super().validate()

    @property
    def input_nc(self) -> int:
        """The generator's input channels: the one-hot labels, and the edge map."""
        return self.label_nc + (0 if self.no_instance else 1)


def parse_pix2pixhd(argv=None) -> Pix2PixHDConfig:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser("pix2pixhd")
    p.add_argument("--dataroot", type=str, required=True,
                   help="folder of {phase}_label/, {phase}_inst/ and {phase}_img/ (Cityscapes)")
    p.add_argument("--phase", type=str, default=None,
                   help="the folders' prefix (default: train for --train, test for --predict)")
    p.add_argument("--loadSize", dest="load_size", type=int, default=1024,
                   help="scale images to this width")
    p.add_argument("--batchSize", dest="batch_size", type=int, default=1, help="input batch size")
    p.add_argument("--label_nc", type=int, default=35, help="# of input label channels")
    p.add_argument("--ngf", type=int, default=64, help="# of gen filters in first conv layer")
    p.add_argument("--n_downsample_global", type=int, default=4,
                   help="number of downsampling layers in netG")
    p.add_argument("--n_blocks_global", type=int, default=9,
                   help="number of residual blocks in the global generator network")
    p.add_argument("--num_D", type=int, default=2, help="number of discriminators to use")
    p.add_argument("--n_layers_D", type=int, default=3,
                   help="only used if which_model_netD==n_layers")
    p.add_argument("--ndf", type=int, default=64, help="# of discrim filters in first conv layer")
    p.add_argument("--lambda_feat", type=float, default=10.0,
                   help="weight for feature matching loss")
    p.add_argument("--no_vgg_loss", action="store_true",
                   help="if specified, do *not* use VGG feature matching loss")
    p.add_argument("--no_ganFeat_loss", action="store_true",
                   help="if specified, do *not* use discriminator feature matching loss")
    p.add_argument("--no_instance", action="store_true",
                   help="if specified, do *not* add instance map as input")
    p.add_argument("--no_flip", action="store_true",
                   help="if specified, do not flip the images for data argumentation")
    p.add_argument("--vgg_weights", type=str, default=None,
                   help="a torchvision vgg19 state dict (.pth) for the VGG loss; nothing is "
                        "downloaded")
    p.add_argument("--lr", dest="learning_rate", type=float, default=2e-4,
                   help="initial learning rate for adam")
    p.add_argument("--beta1", dest="beta_1", type=float, default=0.5, help="momentum term of adam")
    _add_run_flags(p, argv)
    cfg = Pix2PixHDConfig(**vars(p.parse_args(argv)))
    cfg.validate()
    return cfg
