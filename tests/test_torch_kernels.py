"""The kernel wrappers: on a CPU tensor they run the plain versions; on the
card (``-m cuda``) the CUDA kernels, K1 forward (also with batch norm's
epsilon, as per-image batch norm runs it) and K2 backward, are held against
the plain versions at the generator's shapes, the PatchGAN's 31² site, the
edges of their cluster plans and the unstaged 256²×64 site of the 512²
generator, and rerun bit for bit; the stem kernel S,
forward and backward, at every C_in it takes, and its bf16 tensor-core route
also on other launch plans, on a misaligned input and rerun bit for bit. This
file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from gan_tpu_torch.ops import conv, kernels, norm
from torch_inputs import limit_threads, norm_inputs

limit_threads()

# fp32: the kernel's per-band two-pass sums merged with Chan's formula vs
# the plain version's two-pass sums
NORM_ATOL = 2e-5
# K1's and K2's cluster plans at their edges: one sample at the largest site
# (16 blocks in one cluster), 31² rows that no band size divides, C = 3 (one
# channel per load), C = 80 (a channel tile with a ragged tail) split over a
# cluster of 8
EDGE_SHAPES = [(1, 128, 128, 64), (2, 31, 31, 512), (2, 8, 8, 3), (2, 32, 32, 80)]
# the 512² U-Net's last up block, at batch 1 and the training batch of 4: its
# bands exceed shared memory, so K1 and K2 read x (and dy) from global memory
# twice instead of staging them (the plan's staged = 0)
UNSTAGED_SHAPES = [(1, 256, 256, 64), (4, 256, 256, 64)]


def test_wrapper_on_cpu_runs_the_plain_version():
    x, scale, offset = norm_inputs((2, 4, 4, 64))
    args = [torch.from_numpy(a) for a in (x, scale, offset)]
    before = kernels.LAUNCHES["instance_norm_fwd"]
    got = kernels.instance_norm(*args, act="relu")
    torch.testing.assert_close(got, norm.instance_norm(*args, act="relu"), rtol=0, atol=0)
    assert kernels.LAUNCHES["instance_norm_fwd"] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "leaky_relu", "relu"])
@pytest.mark.parametrize("shape", [(16, 1, 1, 512), (16, 2, 2, 512), (4, 16, 16, 256),
                                   (2, 128, 128, 64), (3, 3, 5, 80), *EDGE_SHAPES,
                                   *UNSTAGED_SHAPES])
def test_instance_norm_kernel_matches_plain(cuda_device, shape, act, dtype):
    x, scale, offset = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs(shape))
    x = x.to(dtype)
    before = kernels.LAUNCHES["instance_norm_fwd"]
    got = kernels.instance_norm(x, scale, offset, act=act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["instance_norm_fwd"] == before + 1
    want = norm.instance_norm(x, scale, offset, act=act)
    # fp32: Welford vs two-pass sums; bf16: one output rounding, 1 ulp = 2^-7 relative
    atol, rtol = (NORM_ATOL, 1e-5) if dtype == torch.float32 else (1e-3, 2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 1, 1, 512), (16, 2, 2, 512), (2, 128, 128, 64)])
def test_instance_norm_kernel_with_batch_norm_eps_matches_plain(cuda_device, shape, dtype):
    """Per-image batch norm: K1 with eps 1e-3, tolerances as above."""
    x, scale, offset = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs(shape))
    x = x.to(dtype)
    got = kernels.instance_norm(x, scale, offset, eps=norm.BN_EPS)
    torch.cuda.synchronize()
    want = norm.instance_norm(x, scale, offset, eps=norm.BN_EPS)
    atol, rtol = (NORM_ATOL, 1e-5) if dtype == torch.float32 else (1e-3, 2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_backward_wrapper_on_cpu_runs_the_plain_version():
    x, scale, _ = norm_inputs((2, 4, 4, 64))
    dy = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, scale, dy)]
    before = kernels.LAUNCHES["instance_norm_bwd"]
    for got, want in zip(kernels.instance_norm_backward(*args), norm.instance_norm_backward(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.LAUNCHES["instance_norm_bwd"] == before


@pytest.mark.parametrize("case", ["dtype", "shape"])
def test_backward_wrapper_refuses_a_dy_unlike_x(case):
    x, scale, _ = (torch.from_numpy(a) for a in norm_inputs((2, 4, 4, 64)))
    dy = x.bfloat16() if case == "dtype" else x[:1]
    with pytest.raises(TypeError, match="dy must match x"):
        kernels.instance_norm_backward(x, scale, dy)


# K2 vs its plain version. dx, fp32: the same formula, per-band two-pass
# statistics merged with Chan's formula (kernel) vs two-pass (plain), and
# sums in other orders; bf16: the same bf16
# x and dy and fp32 math, dx's one rounding may land one ulp apart. dscale
# and doffset: fp32 sums over N·H·W terms. Each thread sums its rows of a
# band in order (at most H·W/32 terms), then trees over the block, the
# cluster and N add them up, so the error grows no faster than with the
# count (1e-7 per term, at least 1e-5).
DX_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}   # (atol, rtol)


def sums_tol(shape):
    return 1e-5 + 1e-7 * shape[0] * shape[1] * shape[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 1, 1, 512), (16, 2, 2, 512), (4, 16, 16, 256),
                                   (2, 128, 128, 64), (3, 3, 5, 80), *EDGE_SHAPES,
                                   *UNSTAGED_SHAPES])
def test_instance_norm_backward_kernel_matches_plain(cuda_device, shape, dtype):
    x, scale, _ = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs(shape))
    x = x.to(dtype)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    dy = dy.to(cuda_device, dtype)
    before = kernels.LAUNCHES["instance_norm_bwd"]
    got = kernels.instance_norm_backward(x, scale, dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["instance_norm_bwd"] == before + 1
    want = norm.instance_norm_backward(x, scale, dy)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    atol, rtol = DX_TOL[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=rtol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=sums_tol(shape), rtol=1e-5)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous tensor whose address is one element
    past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_kernels_on_a_misaligned_tensor(cuda_device, dtype):
    """An address off the 16-byte grid takes the one-channel loads, unstaged;
    K1 and K2 still match the plain versions."""
    shape = (2, 64, 64, 64)
    x, scale, offset = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs(shape))
    x = _misaligned(x.to(dtype))
    dy = _misaligned(torch.randn(shape, device=cuda_device).to(dtype))
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    atol, rtol = DX_TOL[dtype]
    got = kernels.instance_norm(x, scale, offset)
    torch.testing.assert_close(got.float(), norm.instance_norm(x, scale, offset).float(),
                               atol=atol, rtol=rtol)
    got = kernels.instance_norm_backward(x, scale, dy)
    want = norm.instance_norm_backward(x, scale, dy)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=rtol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=sums_tol(shape), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (8, 31, 31, 512), (2, 32, 32, 80)])
def test_instance_norm_kernels_rerun_bit_identical(cuda_device, shape, dtype):
    """Two launches on the same input give the same bits: K1's y, and K2's
    dx, dscale and doffset (the cluster merges in rank order, no atomics)."""
    x, scale, offset = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs(shape))
    x = x.to(dtype)
    dy = torch.randn(shape, device=cuda_device).to(dtype)
    runs = [(kernels.instance_norm(x, scale, offset, act="leaky_relu"),
             *kernels.instance_norm_backward(x, scale, dy)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_instance_norm_autograd_launches_k1_then_k2(cuda_device):
    """Through autograd: K1 forward, K2 backward on a strided dy (a slice of
    a cat, as in the U-Net), against the plain version's autograd."""
    x, scale, offset = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs((2, 8, 8, 64)))
    cot = torch.randn(2, 8, 8, 96, device=cuda_device)
    grads = []
    for fn in (kernels.instance_norm, norm.instance_norm):
        leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
        before = dict(kernels.LAUNCHES)
        y = torch.cat([fn(*leaves), torch.zeros(2, 8, 8, 32, device=cuda_device)], dim=-1)
        grads.append(torch.autograd.grad((y * cot).sum(), leaves))
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        assert launched == ({"instance_norm_fwd": 1, "instance_norm_bwd": 1, "stem_conv": 0,
                             "adam_update": 0}
                            if fn is kernels.instance_norm else
                            {"instance_norm_fwd": 0, "instance_norm_bwd": 0, "stem_conv": 0,
                             "adam_update": 0})
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_card_launches_count_launches_and_graph_replays(cuda_device):
    """The kernels' own counters on the card: one per launch of K1, K2, S
    and Adam's update, and one per launch in each replay of a CUDA graph
    that captured them, where the wrappers' ``LAUNCHES`` see the capture
    only."""
    x, scale, offset = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs((2, 8, 8, 64)))
    dy = torch.randn_like(x)
    xs = torch.randn(2, 16, 16, 1, device=cuda_device)
    w = torch.randn(64, 1, 4, 4, device=cuda_device).contiguous(memory_format=torch.channels_last)
    p = torch.zeros(300, device=cuda_device)
    opt = torch.optim.Adam([p], lr=2e-4, capturable=True)
    g = torch.randn_like(p)

    def step():
        kernels.instance_norm(x, scale, offset)
        kernels.instance_norm_backward(x, scale, dy)
        kernels.stem_conv(xs, w)
        kernels.adam_step([opt], [[g]])

    one = {"instance_norm_fwd": 1, "instance_norm_bwd": 1, "stem_conv": 1, "adam_update": 1}
    before = kernels.card_launches()
    step()
    assert {k: v - before[k] for k, v in kernels.card_launches().items()} == one
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()   # the warm-up a capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    host, before = dict(kernels.LAUNCHES), kernels.card_launches()
    for _ in range(3):
        graph.replay()
    assert {k: v - before[k] for k, v in kernels.card_launches().items()} == {
        k: 3 for k in one}
    assert kernels.LAUNCHES == host


@pytest.mark.cuda
def test_instance_norm_epilogue_refuses_grad(cuda_device):
    """K3's backward (dy masked inside K2) is not ported yet."""
    x = torch.randn(1, 4, 4, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="epilogue"):
        kernels.instance_norm(x, torch.ones(32, device=cuda_device),
                              torch.zeros(32, device=cuda_device), act="relu")


def _stem_inputs(shape, device, dtype=torch.float32, seed=6):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(device)
    w = torch.from_numpy((0.02 * rng.standard_normal((64, shape[-1], 4, 4))).astype(np.float32))
    return x, w.to(device).to(memory_format=torch.channels_last)   # as the models keep it


# S against its plain version. fp32 (TF32 off): 16·C_in products summed in
# another order than cuDNN's. bf16: the same bf16 products summed in fp32;
# the kernel rounds once after the LeakyReLU, the plain version rounds the
# conv and then the slope's product: one ulp plus that rounding.
STEM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7 + 2 ** -8)}


def test_stem_wrapper_on_cpu_runs_the_plain_version():
    x, w = _stem_inputs((2, 8, 8, 3), "cpu")
    before = kernels.LAUNCHES["stem_conv"]
    got = kernels.stem_conv(x, w, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(got, conv.stem_conv(x, w, compute_dtype=torch.bfloat16),
                               rtol=0, atol=0)
    assert kernels.LAUNCHES["stem_conv"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
@pytest.mark.parametrize("nhw", [(2, 64, 64), (1, 256, 256), (3, 6, 10), (2, 10, 38)])
def test_stem_kernel_matches_plain(cuda_device, nhw, c_in, dtype):
    torch.backends.cudnn.allow_tf32 = False
    x, w = _stem_inputs((*nhw, c_in), cuda_device)
    before = kernels.LAUNCHES["stem_conv"]
    got = kernels.stem_conv(x, w, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stem_conv"] == before + 1
    want = conv.stem_conv(x, w, compute_dtype=dtype)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    atol, rtol = STEM_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", [1, 2])
def test_stem_autograd_matches_plain(cuda_device, c_in):
    """dx and dw through ``StemConvFunction`` (S forward, cuDNN backward)
    against autograd of the plain version, fp32 with TF32 off: the same
    convolution_backward on the same masked dy (1e-5)."""
    torch.backends.cudnn.allow_tf32 = False
    x, w = _stem_inputs((2, 32, 32, c_in), cuda_device)
    dy = torch.randn(2, 16, 16, 64, device=cuda_device)
    grads = []
    for fn in (kernels.stem_conv, conv.stem_conv):
        leaves = [t.clone().requires_grad_() for t in (x, w)]
        grads.append(torch.autograd.grad(fn(*leaves, compute_dtype=torch.float32), leaves, dy))
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
@pytest.mark.parametrize("rows,warps", [(1, 1), (3, 2), (8, 8), (5, 3)])
def test_stem_bf16_kernel_on_other_plans_matches_plain(cuda_device, c_in, rows, warps):
    """The tensor-core kernel on plans other than ``stem_plan``'s: blocks of
    1 to 8 warps over 1 to 8 rows, so warps take several tiles, rows end
    mid-tile and the last block is short (W_o = 19, H_o = 13)."""
    torch.backends.cudnn.allow_tf32 = False
    x, w = _stem_inputs((2, 26, 38, c_in), cuda_device)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    plan = kernels.make_stem_plan(2, 26, 38, c_in, torch.bfloat16, rows, warps)
    got = kernels._launch_stem(x, w, plan=plan)
    torch.cuda.synchronize()
    atol, rtol = STEM_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), conv.stem_conv(x, w).float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
def test_stem_bf16_kernel_on_a_misaligned_input(cuda_device, c_in):
    """x 2 bytes off the 4-byte grid (copied by the wrapper) and 4 bytes off
    the 16-byte grid (4-byte loads in place of cp.async)."""
    torch.backends.cudnn.allow_tf32 = False
    x, w = _stem_inputs((2, 16, 16, c_in), cuda_device)
    x = x.to(torch.bfloat16)
    want = conv.stem_conv(x, w, compute_dtype=torch.bfloat16).float()
    atol, rtol = STEM_TOL[torch.bfloat16]
    for shift in (1, 2):
        buf = torch.empty(x.numel() + shift, dtype=x.dtype, device=cuda_device)
        xm = buf[shift:].view(x.shape)
        xm.copy_(x)
        assert xm.data_ptr() % 16 and xm.is_contiguous()
        got = kernels.stem_conv(xm, w, compute_dtype=torch.bfloat16)
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
def test_stem_bf16_kernel_reruns_bit_identical(cuda_device, c_in):
    """No atomics: two launches give the same bits."""
    x, w = _stem_inputs((4, 64, 64, c_in), cuda_device)
    runs = [kernels.stem_conv(x, w, compute_dtype=torch.bfloat16) for _ in range(2)]
    assert torch.equal(*runs)



# pix2pixHD at batch 1: the generator's largest site (unstaged, 32 blocks),
# the residual blocks' 32x64x1024, and the discriminators' non-square sites;
# its norms have no affine parameters (scale 1, offset 0)
HD_SHAPES = [(1, 512, 1024, 64), (1, 256, 512, 128), (1, 32, 64, 1024), (1, 129, 257, 128),
             (1, 66, 130, 512), (1, 33, 65, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HD_SHAPES)
def test_instance_norm_kernels_at_the_pix2pixhd_sites(cuda_device, shape, dtype):
    """K1 and K2 against the plain versions with constant ones and zeros,
    the tolerances above."""
    x, _, _ = (torch.from_numpy(a).to(cuda_device) for a in norm_inputs(shape))
    x = x.to(dtype)
    ones = torch.ones(shape[-1], device=cuda_device)
    zeros = torch.zeros(shape[-1], device=cuda_device)
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(shape).astype(np.float32))
    dy = dy.to(cuda_device, dtype)
    got = kernels.instance_norm(x, ones, zeros)
    got_bwd = kernels.instance_norm_backward(x, ones, dy)
    torch.cuda.synchronize()
    atol, rtol = (NORM_ATOL, 1e-5) if dtype == torch.float32 else (1e-3, 2 ** -7)
    torch.testing.assert_close(got.float(), norm.instance_norm(x, ones, zeros).float(),
                               atol=atol, rtol=rtol)
    want = norm.instance_norm_backward(x, ones, dy)
    atol, rtol = DX_TOL[dtype]
    torch.testing.assert_close(got_bwd[0].float(), want[0].float(), atol=atol, rtol=rtol)
    for g, w in zip(got_bwd[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=sums_tol(shape), rtol=1e-5)
