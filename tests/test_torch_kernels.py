"""The instance-norm kernel wrapper: on a CPU tensor it runs the plain
version; on the card (``-m cuda``) the CUDA kernel is held against the plain
version at the generator's shapes. This file imports no jax, so it also runs
where jax is absent:

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


@pytest.mark.cuda
def test_instance_norm_kernel_refuses_grad(cuda_device):
    x = torch.randn(1, 4, 4, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2"):
        kernels.instance_norm(x, torch.ones(32, device=cuda_device),
                              torch.zeros(32, device=cuda_device))
