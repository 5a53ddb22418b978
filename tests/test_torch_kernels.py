"""The instance-norm kernel wrappers: on a CPU tensor they run the plain
versions; on the card (``-m cuda``) the CUDA kernels, K1 forward and K2
backward, are held against the plain versions at the generator's shapes and
the PatchGAN's 31² site. This file imports no jax, so it also runs where jax
is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from gan_tpu_torch.ops import kernels, norm
from torch_inputs import norm_inputs

# fp32: Welford (kernel) vs two-pass (plain) fp32 sums
NORM_ATOL = 2e-5


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
                                   (2, 128, 128, 64), (3, 3, 5, 80)])
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


# K2 vs its plain version. dx, fp32: the same formula, Welford (kernel) vs
# two-pass (plain) statistics and sums in other orders; bf16: the same bf16
# x and dy and fp32 math, dx's one rounding may land one ulp apart. dscale
# and doffset: fp32 sums over N·H·W terms, each thread's share summed in
# order, so the error grows with the count (1e-7 per term, at least 1e-5).
DX_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}   # (atol, rtol)


def sums_tol(shape):
    return 1e-5 + 1e-7 * shape[0] * shape[1] * shape[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 1, 1, 512), (16, 2, 2, 512), (4, 16, 16, 256),
                                   (2, 128, 128, 64), (3, 3, 5, 80), (2, 31, 31, 512)])
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
        assert launched == ({"instance_norm_fwd": 1, "instance_norm_bwd": 1}
                            if fn is kernels.instance_norm else
                            {"instance_norm_fwd": 0, "instance_norm_bwd": 0})
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_instance_norm_epilogue_refuses_grad(cuda_device):
    """K3's backward (dy masked inside K2) is not ported yet."""
    x = torch.randn(1, 4, 4, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="epilogue"):
        kernels.instance_norm(x, torch.ones(32, device=cuda_device),
                              torch.zeros(32, device=cuda_device), act="relu")
