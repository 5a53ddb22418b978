"""The stem kernel S (``gan_tpu_torch/csrc/stem_conv.cu``) on the CPU: its
bf16 route is an implicit GEMM on the tensor cores, and what it computes,
where it reads its operands and how it is launched are held here, where no
card runs it.

- the GEMM formulation: im2col with the kernel's K order k = (a·4 + b)·C_in
  + c, times the OHWI weight as a (64, 16·C_in) matrix, then LeakyReLU, is
  the plain ``conv.stem_conv``;
- the kernel's addressing, replayed in numpy: the staged rows of a block
  (pitch and lead from the plan, zero columns and rows), read at the offsets
  the A fragments use, hold the im2col matrix; the B fragments of
  ``mma.sync.m16n8k16`` cover the weight once; the swizzled staging tile of
  the epilogue returns each C fragment value to its pixel and filter;
- ``kernels.stem_plan`` at every stem shape of ``chip_smoke.py`` (256² and
  512²), at the
  ``cuda`` tests' shapes and at the edge widths: the grid covers every
  output row once, the shared memory fits a block, the M tiles cover the
  block's pixels with the ragged tail masked.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gan_tpu_torch.ops import conv, kernels
from torch_inputs import limit_threads

limit_threads()

DTYPES = [torch.bfloat16, torch.float32]
SMALL_SHAPES = [(2, 8, 8), (1, 6, 10), (3, 4, 14)]
# the cuda tests' shapes, widths with a ragged M tile, W = 2 (one output
# column), W = 32 (one whole tile a row) and wide rows at the largest C_in
CUDA_SHAPES = [(2, 64, 64), (1, 256, 256), (3, 6, 10), (2, 10, 38)]
EDGE_SHAPES = [(1, 2, 2), (4, 4, 2), (2, 32, 32), (2, 34, 34), (1, 8, 1024), (1, 4, 2048),
               (64, 256, 256)]
PLAN_CASES = sorted({(n, size, size, c) for size in (chip_smoke.IMG_SIZE, chip_smoke.IMG_512)
                     for n, c in chip_smoke.stem_shapes(size)}
                    | {(*nhw, c) for nhw in CUDA_SHAPES + EDGE_SHAPES
                       for c in kernels.STEM_CHANNELS})


def _inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((64, shape[-1], 4, 4))).astype(np.float32)   # OIHW
    return x, w


def _k_order(c_in):
    """(a, b, c) of each k: k = (a·4 + b)·C_in + c."""
    return [(k // c_in // 4, k // c_in % 4, k % c_in) for k in range(16 * c_in)]


def _im2col(x, c_in):
    """(N·H/2·W/2, 16·C_in) patches of the 1-padded input in the K order."""
    n, h, w, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = [xp[:, a:a + h:2, b:b + w:2, c] for a, b, c in _k_order(c_in)]
    return np.stack(cols, axis=-1).reshape(-1, 16 * c_in)


@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
@pytest.mark.parametrize("nhw", SMALL_SHAPES)
def test_gemm_formulation_matches_plain_stem(nhw, c_in):
    """im2col · OHWI weight, then LeakyReLU(0.3), is ``conv.stem_conv``
    within fp32 rounding (products and sums in float64 here)."""
    x, w = _inputs((*nhw, c_in))
    w_ohwi = w.transpose(0, 2, 3, 1).reshape(64, -1)   # B's column f is w[f] as it lies in memory
    z = _im2col(x.astype(np.float64), c_in) @ w_ohwi.astype(np.float64).T
    got = np.where(z >= 0, z, 0.3 * z).reshape(nhw[0], nhw[1] // 2, nhw[2] // 2, 64)
    want = conv.stem_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def _staged_rows(x, sample, row0, rows, plan, c_in):
    """A block's shared-memory rows as the bf16 kernel stages them: 2·rows +
    2 input rows from 2·row0 − 1, ``plan.pitch`` elements apart, padded
    column 0 at ``stem_lead``, the image from the column after it, zeros
    outside the image. Unwritten elements are NaN, so reading one shows."""
    h, w = x.shape[1:3]
    lead = kernels.stem_lead(c_in)
    x_s = np.full((2 * rows + 2) * plan.pitch, np.nan)
    for r in range(2 * rows + 2):
        hi = 2 * row0 - 1 + r
        row = x[sample, hi].reshape(-1) if 0 <= hi < h else np.zeros(w * c_in)
        start = r * plan.pitch + lead
        x_s[start:start + (w + 2) * c_in] = np.concatenate([np.zeros(c_in), row,
                                                            np.zeros(c_in)])
    return x_s


@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
@pytest.mark.parametrize("nhw", SMALL_SHAPES + [(2, 10, 38), (1, 4, 2)])
def test_staged_rows_hold_the_a_operand(nhw, c_in):
    """Every block of the plan, every M tile: lane l's A words, pixel base
    2·(p / W_o)·pitch + 2·(p % W_o)·C_in + lead plus k's offset (k / (4·C_in))
    ·pitch + k % (4·C_in), hold the im2col matrix's pairs (k, k+1) at k =
    16·step + 2·(l % 4) + {0, 8}: at even elements where C_in is even, at
    odd ones (read as the two words around them) where it is odd; the last
    tile clamps its pixels to the span."""
    n, h, w = nhw
    x, _ = _inputs((*nhw, c_in))
    want = _im2col(x, c_in).reshape(n, h // 2, w // 2, 16 * c_in)
    plan = kernels.stem_plan(n, h, w, c_in, torch.bfloat16)
    ho, wo, lead = h // 2, w // 2, kernels.stem_lead(c_in)
    assert plan.pitch % 8 == 0 and (lead + c_in) % 8 == 0
    for sample in range(n):
        for row0 in range(0, ho, plan.rows_per_block):
            rows = min(plan.rows_per_block, ho - row0)
            x_s = _staged_rows(x, sample, row0, rows, plan, c_in)
            pixels = rows * wo
            for p0 in range(0, pixels, kernels.STEM_TILE):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for p in (min(p0 + g, pixels - 1), min(p0 + g + 8, pixels - 1)):
                        base = 2 * (p // wo) * plan.pitch + 2 * (p % wo) * c_in + lead
                        for step in range(c_in):
                            for k in (16 * step + 2 * t, 16 * step + 2 * t + 8):
                                off = k // (4 * c_in) * plan.pitch + k % (4 * c_in)
                                e = base + off
                                assert e % 2 == c_in % 2
                                pair = x_s[e:e + 2]
                                if c_in % 2:   # the words (e - 1, e), (e + 1, e + 2) exist
                                    assert e - 1 >= 0 and e + 2 < len(x_s)
                                np.testing.assert_array_equal(
                                    pair, want[sample, row0 + p // wo, p % wo, k:k + 2])


# the most distinct shared-memory words one A load of a warp puts in one
# bank at 256²: the plan's pitch keeps window rows a and a + 1 apart; at C_in
# 3 and 6 a lane's pixels lie 3 and 6 words apart, so some pairs of lanes share
# a bank whatever the pitch
A_LOAD_WAYS = {1: 1, 2: 1, 3: 2, 6: 2}


@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
def test_a_loads_bank_conflicts(c_in):
    plan = kernels.stem_plan(8, 256, 256, c_in, torch.bfloat16)
    lead = kernels.stem_lead(c_in)
    worst = 0
    for p0 in range(0, 128, kernels.STEM_TILE):   # the tiles of one output row
        for step in range(c_in):
            for half in (0, 8):
                for rows8 in (0, 8):                  # A registers of rows g and g + 8
                    for word_of in ((lambda e: e // 2),) if c_in % 2 == 0 else (
                            (lambda e: (e - 1) // 2), (lambda e: (e + 1) // 2)):
                        banks = {}
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            k = 16 * step + 2 * t + half
                            e = (2 * (p0 + g + rows8) * c_in + lead
                                 + k // (4 * c_in) * plan.pitch + k % (4 * c_in))
                            banks.setdefault(word_of(e) % 32, set()).add(word_of(e))
                        worst = max(worst, max(len(w) for w in banks.values()))
    assert worst == A_LOAD_WAYS[c_in]


@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
def test_b_fragments_cover_the_weight_once(c_in):
    """The kernel fills its B fragments word i of [step][filter-tile pair]
    [lane][4] from OHWI word (f·16·C_in + k) / 2; lane l's words of a pair are
    (b0b1, b2b3) of filter tiles 2·pair and 2·pair + 1, i.e. filter
    8·tile + l / 4 at k = 16·step + 2·(l % 4) + {0, 8}. Each (f, k even)
    appears once."""
    seen = {}
    for i in range(c_in * 4 * 32 * 4):
        e, lane, pair, step = i & 3, (i >> 2) & 31, (i >> 7) & 3, i >> 9
        tile = 2 * pair + (e >> 1)
        f = tile * 8 + (lane >> 2)
        k = step * 16 + 2 * (lane & 3) + 8 * (e & 1)
        assert (f * 16 * c_in + k) % 2 == 0
        assert (f, k) not in seen
        seen[(f, k)] = i
    assert set(seen) == {(f, k) for f in range(64) for k in range(0, 16 * c_in, 2)}


def test_epilogue_tile_returns_each_value_to_its_pixel_and_filter():
    """C fragment (lane l: rows l / 4 and l / 4 + 8, filters 8·nt + 2·(l % 4)
    + {0, 1}) written to word row·32 + ((nt ^ l / 4) << 2) + l % 4, then read
    as 16-byte chunk (row·8 + (q ^ row % 8)) for chunk q of the row: every
    pixel's 64 filters come back in order, and each write and each
    quarter-warp read touches 32 banks once."""
    tile = np.full(16 * 32, -1, dtype=np.int64)
    for nt in range(8):
        banks = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            word = ((nt ^ g) << 2) + t
            for row in (g, g + 8):
                assert tile[row * 32 + word] == -1
                tile[row * 32 + word] = row * 64 + nt * 8 + 2 * t   # its first filter
            banks.append(word % 32)
        assert sorted(banks) == list(range(32))
    for it in range(4):
        for quarter in range(4):
            lanes = range(quarter * 8, quarter * 8 + 8)
            rows = {it * 4 + (lane >> 3) for lane in lanes}
            assert len(rows) == 1
            chunks = [(lane & 7) ^ ((it * 4 + (lane >> 3)) & 7) for lane in lanes]
            assert sorted(chunks) == list(range(8))
            for lane in lanes:
                r, q = it * 4 + (lane >> 3), lane & 7
                words = tile[(r * 8 + (q ^ (r & 7))) * 4:][:4]
                np.testing.assert_array_equal(words, r * 64 + q * 8 + 2 * np.arange(4))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,h,w,c_in", PLAN_CASES)
def test_stem_plan_covers_the_output_on_a_launchable_block(n, h, w, c_in, dtype):
    plan = kernels.stem_plan(n, h, w, c_in, dtype)
    ho, wo = h // 2, w // 2
    rows = plan.rows_per_block
    assert plan.grid == (-(-ho // rows), n)
    covered = [r for b in range(plan.grid[0]) for r in range(b * rows, min((b + 1) * rows, ho))]
    assert covered == list(range(ho))
    assert plan.smem_bytes <= kernels.MAX_SMEM
    assert 1 <= plan.warps <= kernels.MAX_THREADS // 32
    if dtype == torch.float32:   # the CUDA-core kernel: 256 threads, unpadded rows
        assert (plan.warps, plan.pitch, plan.vec) == (8, (w + 2) * c_in, 1)
        assert plan.smem_bytes <= kernels.STEM_FP32_SMEM or rows == 1
        return
    # the M tiles of a full block and of the last, shorter one: whole tiles
    # but the last, whose masked tail is shorter than a tile; no warp of a
    # full block without a tile
    tiles = {}
    for block_rows in (rows, ho - (plan.grid[0] - 1) * rows):
        pixels = block_rows * wo
        tiles[block_rows] = -(-pixels // kernels.STEM_TILE)
        assert 0 <= tiles[block_rows] * kernels.STEM_TILE - pixels < kernels.STEM_TILE
    assert plan.warps <= tiles[rows]
    lead = kernels.stem_lead(c_in)
    assert plan.pitch % 8 == 0 and plan.pitch >= lead + (w + 2) * c_in
    assert plan.pitch % 64 == 32   # window rows a and a + 1 in different banks
    assert plan.vec == (8 if w * c_in % 8 == 0 else 2)
    assert (lead + c_in) % 8 == 0   # the image's first column on 16 bytes, for cp.async
    if c_in % 2:   # the word after an odd pair's last element lies in the row's pitch
        assert lead + (w + 2) * c_in < plan.pitch
    if (n, h, w, c_in) in PLAN_CASES and n * ho * wo >= 8 * 128 * 128:
        # the paths' shapes: about two blocks for every SM, each in at most
        # half an SM's shared memory
        assert plan.grid[0] * plan.grid[1] >= kernels.TARGET_BLOCKS
        assert plan.smem_bytes <= kernels.SMEM_BUDGET


@pytest.mark.parametrize("c_in", kernels.STEM_CHANNELS)
def test_stem_plan_of_a_misaligned_input_loads_4_bytes(c_in):
    plan = kernels.stem_plan(2, 64, 64, c_in, torch.bfloat16, aligned=False)
    assert plan.vec == 2
