"""Convolution primitives with TF-'same' parity (counterpart of gan_tpu/ops/conv.py).

Activations are NHWC at these functions' boundaries, as in gan_tpu. Inside,
the NHWC tensor is handed to cuDNN as its logical-NCHW permutation, which is
``torch.channels_last`` memory: no copy on the way in, and the channels-last
output permutes back to a contiguous NHWC tensor (the ``.contiguous()`` is a
no-op then). Kernels are in torch layouts: a conv weight is OIHW (gan_tpu's
HWIO ``permute(3, 2, 0, 1)``), a transposed-conv weight is ``(C_in, C_out,
k, k)`` (TF's ``(k, k, C_out, C_in)`` ``permute(3, 2, 0, 1)``).

``compute_dtype`` casts input and weight before the conv, as gan_tpu does
(conv.py:38-40); the output stays in that dtype.

gan_tpu's space-to-depth stem and phased tanh head are v5e speed rewrites,
numerically identical to these forms, and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gan_tpu_torch.ops.norm import activation


def _same_pad(in_size: int, stride: int, k: int) -> tuple[int, int]:
    """TF 'SAME' padding (lo, hi) for one spatial dim."""
    out = -(-in_size // stride)  # ceil
    total = max((out - 1) * stride + k - in_size, 0)
    lo = total // 2
    return lo, total - lo


def _cast(x, w, compute_dtype):
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    return x, w


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d_same(x, w, stride: int = 2, *, compute_dtype=None):
    """Stride-``s`` 'same' convolution. x: (N, H, W, C_in); w: (C_out, C_in, k, k).
    Output (N, ceil(H/s), ceil(W/s), C_out)."""
    x, w = _cast(x, w, compute_dtype)
    k = w.shape[-1]
    (lo_h, hi_h), (lo_w, hi_w) = _same_pad(x.shape[1], stride, k), _same_pad(x.shape[2], stride, k)
    xc = _nchw(x)
    if lo_h == hi_h and lo_w == hi_w:
        return _nhwc(F.conv2d(xc, w, stride=stride, padding=(lo_h, lo_w)))
    # odd sizes: TF pads one more on the high side than on the low side
    return _nhwc(F.conv2d(F.pad(xc, (lo_w, hi_w, lo_h, hi_h)), w, stride=stride))


def conv2d_down(x, w, *, compute_dtype=None):
    """Stride-2 'same' conv — the U-Net downsample conv."""
    return conv2d_same(x, w, 2, compute_dtype=compute_dtype)


def stem_conv(x, w, *, compute_dtype=None):
    """The stem block without a norm: LeakyReLU(0.3) of :func:`conv2d_down`.
    The plain version of the fused kernel S (gan_tpu_torch/ops/kernels.py:
    stem_conv), which every network's first block runs."""
    return activation(conv2d_down(x, w, compute_dtype=compute_dtype), "leaky_relu")


def conv2d_valid(x, w, *, pad: int = 0, compute_dtype=None):
    """Stride-1 VALID conv of ``x`` zero-padded by ``pad`` on each spatial
    side: the PatchGAN's ZeroPadding2D(1) → Conv(k4 s1 'valid') pairs
    (gan_tpu/ops/conv.py:108-116 after ``jnp.pad``), the pad folded into the
    conv. x: (N, H, W, C_in); w: (C_out, C_in, k, k)."""
    x, w = _cast(x, w, compute_dtype)
    return _nhwc(F.conv2d(_nchw(x), w, stride=1, padding=pad))


def conv2d_transpose_up(x, w, stride: int = 2, *, compute_dtype=None):
    """Stride-``s`` 'same' transposed conv (TF ``Conv2DTranspose``), the exact
    adjoint of :func:`conv2d_same`. x: (N, H, W, C_in); w: (C_in, C_out, k, k).
    Output (N, H*s, W*s, C_out)."""
    x, w = _cast(x, w, compute_dtype)
    k = w.shape[-1]
    (lo_h, hi_h), (lo_w, hi_w) = (_same_pad(x.shape[1] * stride, stride, k),
                                  _same_pad(x.shape[2] * stride, stride, k))
    if lo_h != hi_h or lo_w != hi_w:   # k - s odd; never so for the U-Net's k=4, s=2
        raise ValueError(f"asymmetric 'same' transposed conv (k={k}, s={stride}) is not supported")
    return _nhwc(F.conv_transpose2d(_nchw(x), w, stride=stride, padding=(lo_h, lo_w)))


# pix2pixHD's ops (gan_tpu_torch/models/resnet_generator.py, models/multiscale_d.py,
# models/vgg.py): PyTorch's explicit symmetric padding, beside the TF-'same' ones above

def conv2d_pad(x, w, bias=None, *, stride: int = 1, pad: int = 0, compute_dtype=None):
    """``nn.Conv2d(k, stride, padding=pad)``: zero padding of ``pad`` on every
    side, then the conv and its bias. x: (N, H, W, C_in); w: (C_out, C_in, k,
    k); bias: (C_out,) or None. Output (N, (H + 2·pad − k) // stride + 1, ...,
    C_out)."""
    x, w = _cast(x, w, compute_dtype)
    if bias is not None:
        bias = bias.to(w.dtype)
    return _nhwc(F.conv2d(_nchw(x), w, bias, stride=stride, padding=pad))


def conv_transpose2d(x, w, bias=None, *, stride: int = 2, pad: int = 1,
                     output_padding: int = 1, compute_dtype=None):
    """``nn.ConvTranspose2d(k, stride, padding=pad, output_padding)``, pix2pixHD's
    upsampling (k3 s2 p1 op1 doubles H and W). x: (N, H, W, C_in); w: (C_in,
    C_out, k, k); bias: (C_out,) or None."""
    x, w = _cast(x, w, compute_dtype)
    if bias is not None:
        bias = bias.to(w.dtype)
    return _nhwc(F.conv_transpose2d(_nchw(x), w, bias, stride=stride, padding=pad,
                                    output_padding=output_padding))


def reflection_pad(x, pad: int):
    """``nn.ReflectionPad2d(pad)`` of an NHWC tensor: ATen's reflection-pad
    kernel in its 3-d form on the (N, 1, H, W, C) view, which pads H and W
    and leaves C whole, so the NHWC tensor is padded where it lies (the 2-d
    form on the NCHW view would copy it to NCHW and back)."""
    return F.pad(x[:, None], (0, 0, pad, pad, pad, pad), mode="reflect")[:, 0]


def avg_pool3_s2(x):
    """``nn.AvgPool2d(3, stride=2, padding=1, count_include_pad=False)`` of an
    NHWC tensor: the mean of the window's pixels inside the image, the
    multiscale discriminator's downsampling. It pools an NCHW copy: ATen's
    channels-last average pool takes a wrong backward with
    ``count_include_pad=False`` on the card (torch 2.11; its forward is
    right)."""
    y = F.avg_pool2d(_nchw(x).contiguous(), 3, stride=2, padding=1, count_include_pad=False)
    return _nhwc(y)
