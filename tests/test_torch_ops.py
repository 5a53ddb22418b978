"""gan_tpu_torch ops against gan_tpu's on the CPU: convs, instance norm (the
plain version against gan_tpu's XLA twin and against the Pallas kernel in
interpret mode), and the host data helpers. Inputs come from numpy seeds;
each tolerance is stated beside its assertion. The CUDA kernel itself is
held against the plain version in test_torch_kernels.py, on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_tpu.data.augment import normalize_batch as jax_normalize_batch
from gan_tpu.data.split import list_images as jax_list_images
from gan_tpu.ops import conv as jax_conv
from gan_tpu.ops import pallas_kernels
from gan_tpu.ops.norm import instance_norm as jax_instance_norm
from gan_tpu.ops.resize import resize_nearest_np as jax_resize_nearest_np
from gan_tpu_torch.data.augment import normalize_batch
from gan_tpu_torch.data.pipeline import resize_nearest_np
from gan_tpu_torch.data.split import list_images
from gan_tpu_torch.ops import conv, kernels, norm
from gan_tpu_torch.transplant import _TO_TORCH
from torch_inputs import norm_inputs

# fp32 convs: both sides sum 16·C_in products in fp32 in different orders
CONV_ATOL = 1e-5
# fp32 instance norm: same two-pass formula, fp32 sums in different orders
NORM_ATOL = 2e-5


def _w_torch(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(_TO_TORCH)))


@pytest.mark.parametrize("hw,stride", [((16, 16), 2), ((7, 9), 2), ((5, 6), 1)])
def test_conv2d_same_matches_gan_tpu(hw, stride):
    # (7, 9) and (5, 6) take TF's asymmetric 'same' pad (one more on the high side)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *hw, 3), dtype=np.float32)
    w = rng.standard_normal((4, 4, 3, 8), dtype=np.float32) * 0.1
    want = np.asarray(jax_conv.conv2d_same(jnp.asarray(x), jnp.asarray(w), stride))
    got = conv.conv2d_same(torch.from_numpy(x), _w_torch(w), stride)
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=CONV_ATOL)


@pytest.mark.parametrize("hw", [(16, 16), (7, 7), (1, 1)])
def test_conv2d_down_and_transpose_up_match_gan_tpu(hw):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, 4), dtype=np.float32)
    w = rng.standard_normal((4, 4, 4, 6), dtype=np.float32) * 0.1      # HWIO
    w_tf = rng.standard_normal((4, 4, 6, 4), dtype=np.float32) * 0.1   # TF convT (k,k,Co,Ci)
    want = np.asarray(jax_conv.conv2d_down(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(conv.conv2d_down(torch.from_numpy(x), _w_torch(w)).numpy(),
                               want, atol=CONV_ATOL)
    want_t = np.asarray(jax_conv.conv2d_transpose_up(jnp.asarray(x), jnp.asarray(w_tf)))
    got_t = conv.conv2d_transpose_up(torch.from_numpy(x), _w_torch(w_tf))
    assert tuple(got_t.shape) == (2, 2 * hw[0], 2 * hw[1], 6) == want_t.shape
    np.testing.assert_allclose(got_t.numpy(), want_t, atol=CONV_ATOL)


def test_conv_compute_dtype_bf16():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 16), dtype=np.float32)
    w = rng.standard_normal((4, 4, 16, 8), dtype=np.float32) * 0.1
    want = np.asarray(jax_conv.conv2d_down(jnp.asarray(x), jnp.asarray(w),
                                           compute_dtype=jnp.bfloat16), np.float32)
    got = conv.conv2d_down(torch.from_numpy(x), _w_torch(w), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # bf16 operands, fp32 accumulate, one bf16 rounding of |y| <= ~4: 2 ulps at 4 is 0.03
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.03, rtol=0.01)


_HW = {1: (1, 1), 4: (2, 2), 256: (16, 16)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hw", [1, 4, 256])
def test_instance_norm_matches_gan_tpu(hw, dtype):
    x, scale, offset = norm_inputs((2, *_HW[hw], 64))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_instance_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                                        jnp.asarray(offset)), np.float32)
    got = norm.instance_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                             torch.from_numpy(offset))
    assert got.dtype == tdt
    # bf16: same bf16 inputs, fp32 statistics; the output's one bf16 rounding
    # may land one ulp apart (2^-7 relative)
    atol, rtol = (NORM_ATOL, 0) if dtype == "fp32" else (1e-3, 2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("act", [None, "leaky_relu", "relu"])
@pytest.mark.parametrize("hw", [1, 4, 256])
def test_instance_norm_matches_pallas_interpret(hw, act):
    """The plain version against K1 itself (interpret mode on the CPU), with
    its activation epilogue. K1's one-pass variance E[x²]−mean² loses a few
    ulps against the two-pass form at |mean| ~ 1, var ~ 9: 1e-4 absolute."""
    x, scale, offset = norm_inputs((2, *_HW[hw], 128), seed=4)
    want = np.asarray(pallas_kernels._in_forward(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(offset), eps=1e-5, act=act))
    got = kernels.instance_norm(torch.from_numpy(x), torch.from_numpy(scale),
                                torch.from_numpy(offset), act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_normalize_and_resize_match_gan_tpu():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (3, 10, 14, 1), dtype=np.uint8)
    np.testing.assert_array_equal(normalize_batch(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jax_normalize_batch(jnp.asarray(u8))))
    for h, w in [(32, 32), (7, 20), (10, 14)]:
        np.testing.assert_array_equal(resize_nearest_np(u8, h, w),
                                      jax_resize_nearest_np(u8, h, w))


def test_list_images_matches_gan_tpu(tmp_path):
    for name in ["a.png", "b.jpg", "c.txt", "pngfile", "d.jpeg"]:
        (tmp_path / name).write_bytes(b"")
    assert sorted(list_images(str(tmp_path))) == sorted(jax_list_images(str(tmp_path)))
    assert sorted(list_images(str(tmp_path))) == sorted(["a.png", "b.jpg", "pngfile"])
