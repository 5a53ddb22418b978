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
from torch_inputs import limit_threads, norm_inputs

limit_threads()

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


# ------------------------------------------------------------ pix2pixHD's ops

def _nchw(t):
    return t.permute(0, 3, 1, 2)


@pytest.mark.parametrize("k,stride,pad,hw", [(3, 1, 1, (9, 14)), (3, 2, 1, (16, 32)),
                                             (4, 2, 2, (17, 33)), (4, 1, 2, (5, 9)),
                                             (7, 1, 0, (12, 20))])
def test_conv2d_pad_equals_nn_conv2d(k, stride, pad, hw):
    """pix2pixHD's convs: k3 p1 at stride 1 and 2, the discriminators' k4 p2,
    the 7x7 after a reflection pad; with their biases."""
    torch.manual_seed(k * 10 + stride)
    m = torch.nn.Conv2d(5, 7, k, stride=stride, padding=pad)
    x = torch.randn(2, *hw, 5)
    got = conv.conv2d_pad(x, m.weight, m.bias, stride=stride, pad=pad)
    want = m(_nchw(x)).permute(0, 2, 3, 1)
    assert got.is_contiguous() and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("hw", [(2, 4), (5, 7), (8, 16)])
def test_conv_transpose2d_equals_nn_conv_transpose2d(hw):
    """k3 s2 p1 output_padding 1: the size doubles, which the TF-'same'
    ``conv2d_transpose_up`` refuses (k − s odd)."""
    torch.manual_seed(3)
    m = torch.nn.ConvTranspose2d(6, 4, 3, stride=2, padding=1, output_padding=1)
    x = torch.randn(2, *hw, 6)
    got = conv.conv_transpose2d(x, m.weight, m.bias)
    want = m(_nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 4) == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=CONV_ATOL)
    with pytest.raises(ValueError, match="asymmetric"):
        conv.conv2d_transpose_up(x, m.weight)


@pytest.mark.parametrize("pad", [1, 3])
def test_reflection_pad_equals_nn_reflection_pad2d(pad):
    x = torch.randn(2, 6, 9, 5)
    got = conv.reflection_pad(x, pad)
    want = torch.nn.ReflectionPad2d(pad)(_nchw(x)).permute(0, 2, 3, 1)
    assert got.is_contiguous() and torch.equal(got, want)


@pytest.mark.parametrize("hw", [(32, 64), (17, 33), (5, 9), (1, 2)])
def test_avg_pool3_s2_equals_nn_avg_pool2d_without_the_pad(hw):
    x = torch.randn(2, *hw, 4)
    got = conv.avg_pool3_s2(x)
    want = torch.nn.AvgPool2d(3, stride=2, padding=1, count_include_pad=False)(_nchw(x))
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0, atol=1e-6)
    corner = x[:, :2, :2].mean(dim=(1, 2))   # the window's pixels inside the image, not 9
    torch.testing.assert_close(got[:, 0, 0], corner, rtol=0, atol=1e-6)


def test_edges_and_one_hot_equal_the_references():
    """pix2pixHD's inputs (``data.labels``) against NVIDIA's ``get_edges``
    and ``scatter_`` one-hot in tests/pix2pixhd_reference.py, flipped rows
    included."""
    import pix2pixhd_reference as ref
    from gan_tpu_torch.data import labels
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(0, 4, (3, 6, 9), generator=g).repeat_interleave(2, 1)
    ids = ids.repeat_interleave(2, 2) * 300
    assert torch.equal(labels.edges(ids), ref.get_edges(ids[:, None])[:, 0].bool())
    rows = torch.randint(0, 256, (3, 12, 18, 6), generator=g, dtype=torch.uint8)
    rows[..., 0] %= 35
    rows[..., 1:3] = torch.stack([ids >> 8, ids & 255], -1).to(torch.uint8)
    flip = torch.tensor([True, False, True])
    for instance in (True, False):
        config = {"label_nc": 35, "no_instance": not instance}
        x, y = labels.hd_inputs(rows, flip, label_nc=35, instance=instance)
        rx, ry = ref.encode_input(rows, flip, config)
        assert torch.equal(x, rx.permute(0, 2, 3, 1)) and torch.equal(y, ry.permute(0, 2, 3, 1))
    assert torch.equal(labels.flip_rows(rows, flip)[0], rows[0].flip(1))
