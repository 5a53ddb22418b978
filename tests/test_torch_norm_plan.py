"""The launch plans of the instance-norm kernels K1 and K2
(``gan_tpu_torch.ops.kernels.norm_plan``), on the CPU: at every norm site
that ``chip_smoke.py`` drives (the 256² generator at the predict chunk of 16
and the training batch of 8, which is also the Pix2Pix predict chunk's per-image
batch norm, and the PatchGAN's sites at batch 8; the 512² generator's and
PatchGAN's sites at batch 1, 4 and 16; and at both sizes every batch of the
CycleGAN steps' passes in both forms, ``chip_smoke.cyclegan_batches``, such
as 2B and 3B of the batched form) and at the edge shapes, in bf16 and
fp32. Each plan's bands cover H·W once and its tiles cover C once, its
cluster and shared memory are ones Hopper can run, and the path's large
sites put at least 128 blocks on the card. The 512² generator's last up
block (256²×64) is the one site whose band exceeds shared memory: its plan
stages nothing."""

import pytest
import torch

import chip_smoke
from gan_tpu_torch.ops import kernels
from gan_tpu_torch.train.base import generator_depth
from torch_inputs import limit_threads

limit_threads()

_GEN_SITES = chip_smoke.norm_sites(chip_smoke.IMG_SIZE, generator_depth(chip_smoke.IMG_SIZE))
# the CycleGAN steps' generator and discriminator pass batches, both forms
_GEN_BATCHES, _DISC_BATCHES = chip_smoke.cyclegan_batches(chip_smoke.IMG_SIZE)
PATH_CASES = sorted({(n, hw * hw, c) for hw, c in _GEN_SITES
                     for n in {chip_smoke.BATCH, chip_smoke.TRAIN_BATCH} | _GEN_BATCHES}
                    | {(n, hw * hw, c) for hw, c in chip_smoke.DISC_NORM_SITES
                       for n in {chip_smoke.TRAIN_BATCH} | _DISC_BATCHES})
_GEN_512 = chip_smoke.norm_sites(chip_smoke.IMG_512, generator_depth(chip_smoke.IMG_512))
_DISC_512 = chip_smoke.disc_norm_sites(chip_smoke.IMG_512)
_GEN_BATCHES_512, _DISC_BATCHES_512 = chip_smoke.cyclegan_batches(chip_smoke.IMG_512)
CASES_512 = sorted({(n, hw * hw, c) for hw, c in _GEN_512 + list(_DISC_512) for n in (1, 4, 16)}
                   | {(n, hw * hw, c) for hw, c in _GEN_512 for n in _GEN_BATCHES_512}
                   | {(n, hw * hw, c) for hw, c in _DISC_512 for n in _DISC_BATCHES_512})
UNSTAGED_SITE = (256 * 256, 64)   # the 512² generator's last up block
# H·W = 1; the (3, 3, 5, 80) test shape; one sample at the largest site; C = 3
EDGE_CASES = [(16, 1, 512), (3, 15, 80), (1, 128 * 128, 64), (2, 64, 3), (4, 32 * 32, 3)]
DTYPES = [torch.bfloat16, torch.float32]


def _is_large(n, hw, c):
    """The path's sites of at least 16²×512 from batch 8 on: enough work
    for a few hundred blocks (the forms' sweep below batch 8 has too few
    instances for that)."""
    return (n, hw, c) in PATH_CASES and hw >= 16 * 16 and n >= chip_smoke.TRAIN_BATCH


def _assert_schedulable_cover(plan, n, hw, c, dtype):
    """The plan's bands cover H·W once and its tiles C once, on a cluster,
    threads and shared memory that Hopper can run, loading 16 bytes where C
    allows it."""
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,hw,c", PATH_CASES + EDGE_CASES)
def test_norm_plan_covers_the_tensor_on_a_schedulable_launch(n, hw, c, dtype):
    for backward in (False, True):
        plan = kernels.norm_plan(n, hw, c, dtype, backward=backward)
        _assert_schedulable_cover(plan, n, hw, c, dtype)
        if plan.vec > 1:   # every band of x fits in shared memory at these sizes
            assert plan.staged >= 1
        if _is_large(n, hw, c):
            assert plan.blocks >= 128, plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,hw,c", CASES_512)
def test_norm_plan_covers_the_512_sites(n, hw, c, dtype):
    """Every site but the last up block's stages x's band; from the
    training batch of 4 on, the sites of at least 64²×256 put at least 128
    blocks on the card (a batch of one has too few instances for that)."""
    for backward in (False, True):
        plan = kernels.norm_plan(n, hw, c, dtype, backward=backward)
        _assert_schedulable_cover(plan, n, hw, c, dtype)
        assert (plan.staged >= 1) == ((hw, c) != UNSTAGED_SITE)
        if n >= 4 and hw * c >= 64 * 64 * 256:
            assert plan.blocks >= 128, plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 4, 16])
def test_norm_plan_of_the_unstaged_512_site(n, dtype):
    """The 256²×64 site: even at 16 blocks to a cluster a band of 4,096 rows
    of a 16-byte-loaded tile exceeds shared memory, so neither K1 nor K2
    stages it (x, and dy, are read from global memory twice), yet the plan
    still loads 16 bytes, covers H·W and C once and fits the limits."""
    hw, c = UNSTAGED_SITE
    for backward in (False, True):
        plan = kernels.norm_plan(n, hw, c, dtype, backward=backward)
        _assert_schedulable_cover(plan, n, hw, c, dtype)
        assert plan.staged == 0 and plan.vec > 1
        assert plan.k == kernels.MAX_CLUSTER
        elt = torch.finfo(dtype).bits // 8
        assert plan.rows_per_block * plan.channel_tile * elt > kernels.SMEM_BUDGET


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,hw,c", PATH_CASES + CASES_512)
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


# pix2pixHD label2city_512p at batch 1 (portbench's pix2pixhd-512p): the
# generator's sites from 512x1024x64 to the nine blocks' 32x64x1024 and the
# two discriminators' non-square sites, as (H·W, C)
HD_GEN_SITES = [(512 * 1024, 64), (256 * 512, 128), (128 * 256, 256), (64 * 128, 512),
                (32 * 64, 1024)]
HD_DISC_SITES = [(129 * 257, 128), (65 * 129, 256), (66 * 130, 512), (65 * 129, 128),
                 (33 * 65, 256), (34 * 66, 512)]
HD_UNSTAGED = {(512 * 1024, 64), (256 * 512, 128)}   # bands past shared memory even at 16 blocks
# sha256 of repr([(n, hw, c, dtype, backward, plan)]) over PATH_CASES + CASES_512, both
# dtypes and directions: the CycleGAN and Pix2Pix sites' plans before pix2pixHD came
PLANS_BEFORE_PIX2PIXHD = "6dd12b679b762ec612145fb6c1bc5444b00b7e019eac756e26200ed3afd99531"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c", HD_GEN_SITES + HD_DISC_SITES)
def test_norm_plan_covers_the_pix2pixhd_sites_at_batch_one(hw, c, dtype):
    """One instance per (sample, tile): the plans stay within a cluster of
    16 and shared memory; every site stages x's band but the two largest,
    whose bands exceed shared memory even at 16 blocks (the unstaged path
    at its largest: 512x1024x64 is 8x the 512² U-Net's 256²x64 site)."""
    for backward in (False, True):
        plan = kernels.norm_plan(1, hw, c, dtype, backward=backward)
        _assert_schedulable_cover(plan, 1, hw, c, dtype)
        assert (plan.staged >= 1) == ((hw, c) not in HD_UNSTAGED)
        if (hw, c) in HD_UNSTAGED:
            assert plan.k == kernels.MAX_CLUSTER
        fwd = kernels.norm_plan(1, hw, c, dtype)
        assert (fwd.k, fwd.channel_tile, fwd.rows_per_block) == (
            plan.k, plan.channel_tile, plan.rows_per_block)


def test_the_existing_sites_keep_their_plans():
    import hashlib
    plans = [(n, hw, c, str(dt), b, tuple(kernels.norm_plan(n, hw, c, dt, backward=b)))
             for n, hw, c in sorted(set(PATH_CASES + CASES_512)) for dt in DTYPES
             for b in (False, True)]
    assert len(plans) == 592
    assert hashlib.sha256(repr(plans).encode()).hexdigest() == PLANS_BEFORE_PIX2PIXHD
