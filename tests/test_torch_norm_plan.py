"""The launch plans of the instance-norm kernels K1 and K2
(``gan_tpu_torch.ops.kernels.norm_plan``), on the CPU: at every norm site
that ``chip_smoke.py`` drives (the 256² generator at the predict chunk of 16
and the training batch of 8, which is also the Pix2Pix predict chunk's per-image
batch norm, and the PatchGAN's sites at batch 8) and at the edge shapes, in
bf16 and fp32. Each plan's bands cover H·W once and its tiles cover C once,
its cluster and shared memory are ones Hopper can run, and the path's large
sites put at least 128 blocks on the card."""

import pytest
import torch

import chip_smoke
from gan_tpu_torch.ops import kernels
from gan_tpu_torch.train.base import generator_depth

_GEN_SITES = chip_smoke.norm_sites(chip_smoke.IMG_SIZE, generator_depth(chip_smoke.IMG_SIZE))
PATH_CASES = sorted({(n, hw * hw, c) for hw, c in _GEN_SITES
                     for n in (chip_smoke.BATCH, chip_smoke.TRAIN_BATCH)}
                    | {(chip_smoke.TRAIN_BATCH, hw * hw, c) for hw, c in chip_smoke.DISC_NORM_SITES})
# H·W = 1; the (3, 3, 5, 80) test shape; one sample at the largest site; C = 3
EDGE_CASES = [(16, 1, 512), (3, 15, 80), (1, 128 * 128, 64), (2, 64, 3), (4, 32 * 32, 3)]
DTYPES = [torch.bfloat16, torch.float32]


def _is_large(n, hw, c):
    """The path's sites of at least 16²×512 at batch 8: enough work for a
    few hundred blocks."""
    return (n, hw, c) in PATH_CASES and hw >= 16 * 16


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,hw,c", PATH_CASES + EDGE_CASES)
def test_norm_plan_covers_the_tensor_on_a_schedulable_launch(n, hw, c, dtype):
    for backward in (False, True):
        plan = kernels.norm_plan(n, hw, c, dtype, backward=backward)
        bands = [range(q * plan.rows_per_block, min((q + 1) * plan.rows_per_block, hw))
                 for q in range(plan.k)]
        assert [r for band in bands for r in band] == list(range(hw))
        assert plan.tiles == -(-c // plan.channel_tile)
        assert (plan.tiles - 1) * plan.channel_tile < c <= plan.tiles * plan.channel_tile
        assert plan.blocks == n * plan.tiles * plan.k
        assert 1 <= plan.k <= kernels.MAX_CLUSTER
        assert plan.portable == (plan.k <= kernels.PORTABLE_CLUSTER)
        assert plan.smem_bytes <= kernels.MAX_SMEM
        lanes = plan.channel_tile // plan.vec
        assert 32 <= plan.threads <= kernels.MAX_THREADS and plan.threads % 32 == 0
        assert lanes <= 32 and lanes & (lanes - 1) == 0
        elt = torch.finfo(dtype).bits // 8
        assert plan.vec == (16 // elt if c % (16 // elt) == 0 else 1)
        if plan.vec > 1:   # every band of x fits in shared memory at these sizes
            assert plan.staged >= 1
        if _is_large(n, hw, c):
            assert plan.blocks >= 128, plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,hw,c", PATH_CASES)
def test_norm_plan_backward_shares_the_forward_geometry(n, hw, c, dtype):
    """K2 recomputes K1's statistics with K1's bands and tiles, so x̂ is the
    forward's bit for bit; only what it stages may differ."""
    fwd = kernels.norm_plan(n, hw, c, dtype)
    bwd = kernels.norm_plan(n, hw, c, dtype, backward=True)
    assert (fwd.k, fwd.channel_tile, fwd.rows_per_block, fwd.vec, fwd.threads) == (
        bwd.k, bwd.channel_tile, bwd.rows_per_block, bwd.vec, bwd.threads)


def test_norm_plan_small_sites_keep_one_block_per_instance():
    for hw in (1, 2 * 2, 4 * 4, 8 * 8):
        assert kernels.norm_plan(16, hw, 512, torch.bfloat16).k == 1


def test_norm_plan_misaligned_or_narrow_loads_one_channel_unstaged():
    for plan in (kernels.norm_plan(2, 4096, 64, torch.bfloat16, aligned=False),
                 kernels.norm_plan(2, 4096, 3, torch.float32)):
        assert (plan.vec, plan.staged, plan.channel_tile) == (1, 0, 32)
