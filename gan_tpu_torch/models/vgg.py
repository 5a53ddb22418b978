"""The frozen VGG19 trunk of pix2pixHD's perceptual loss (NVIDIA/pix2pixHD
models/networks.py ``Vgg19`` and ``VGGLoss``), on NHWC activations: the 13
3x3 convs of torchvision's ``vgg19().features`` up to relu5_1, with ReLU
after each and a 2x2 max pool before each stage, returning relu1_1,
relu2_1, relu3_1, relu4_1 and relu5_1. It takes the [-1, 1] images as they
are (pix2pixHD normalises nothing for it).

Its parameters carry torchvision's names (``features.N.weight`` and
``.bias``), so ``load_torchvision`` takes a torchvision ``vgg19`` state dict
(ImageNet weights the user supplies; nothing is downloaded). The trunk takes
no gradient of its own: its parameters have ``requires_grad`` off, and a
trainer keeps it outside its networks, with no Adam and no checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gan_tpu_torch.models.resnet_generator import ConvParams
from gan_tpu_torch.ops.conv import conv2d_pad

# (torchvision feature index, C_in, C_out) of each conv, in order
CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256), (12, 256, 256),
         (14, 256, 256), (16, 256, 256), (19, 256, 512), (21, 512, 512), (23, 512, 512),
         (25, 512, 512), (28, 512, 512))
POOL_BEFORE = (5, 10, 19, 28)      # a 2x2 max pool precedes these convs
TAPS = (0, 5, 10, 19, 28)          # relu1_1, relu2_1, relu3_1, relu4_1, relu5_1
WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)   # VGGLoss's weight of each tap


def max_pool2(x):
    """``nn.MaxPool2d(2, 2)`` of an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


class VGG19Trunk(nn.Module):
    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.features = nn.ModuleDict({str(i): ConvParams(c_in, c_out, 3, generator)
                                       for i, c_in, c_out in CONVS})
        self.requires_grad_(False)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, *, compute_dtype=None) -> list[torch.Tensor]:
        """x: (N, H, W, 3) in [-1, 1] → the five taps, NHWC."""
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        taps, h = [], x
        for i, _c_in, _c_out in CONVS:
            if i in POOL_BEFORE:
                h = max_pool2(h)
            conv = self.features[str(i)]
            h = torch.relu(conv2d_pad(h, conv.weight, conv.bias, pad=1,
                                      compute_dtype=compute_dtype))
            if i in TAPS:
                taps.append(h)
        return taps

    def load_torchvision(self, state: dict) -> None:
        """The trunk's convs from a torchvision ``vgg19`` state dict (keys
        ``features.N.weight``/``.bias``; the classifier and deeper convs are
        ignored). Raises on a missing key or a shape that differs."""
        mine = self.state_dict()
        missing = [k for k in mine if k not in state]
        if missing:
            raise ValueError(f"the VGG19 state dict lacks {', '.join(missing)}")
        self.load_state_dict({k: state[k] for k in mine})
