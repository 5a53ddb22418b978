"""gan_tpu_torch's U-Net against gan_tpu.models.UNetGenerator on the CPU, on
transplanted weights: dropout off in fp32 and bf16, dropout on with the same
masks injected into both, and the transplant round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gan_tpu.models.blocks as jax_blocks
from gan_tpu.models import UNetGenerator as JaxUNet
from gan_tpu_torch.models import UNetGenerator
from gan_tpu_torch.transplant import state_dict_to_params, params_to_state_dict


def _pair(depth, seed=0, in_channels=1):
    jax_gen = JaxUNet(out_channels=in_channels, norm="instance", depth=depth)
    params = jax_gen.init(jax.random.PRNGKey(seed), in_channels)
    # init offsets are 0, and instance norm at H·W = 1 returns the offset
    # exactly, so an untrained bottleneck carries nothing; trained ones are not 0
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key == "offset" else a, params)
    gen = UNetGenerator(in_channels, in_channels, norm="instance", depth=depth)
    gen.load_state_dict(params_to_state_dict(params))
    return jax_gen, params, gen


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_unet_matches_gan_tpu_without_dropout(dtype):
    jax_gen, params, gen = _pair(depth=5)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    jdt, tdt = (None, None) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_gen.apply(params, jnp.asarray(x), rng=None, compute_dtype=jdt))
    with torch.no_grad():
        got = gen(torch.from_numpy(x), compute_dtype=tdt).numpy()
    assert got.shape == want.shape == (2, 32, 32, 1) and got.dtype == np.float32
    # fp32: 11 convs and 8 norms of fp32 sums in different orders (seen: 1.5e-6).
    # bf16: each framework rounds activations to bf16 at its own points; the
    # ~2^-8 relative differences pass through 5 renormalizing layers (seen: 6e-3).
    atol = 2e-5 if dtype == "fp32" else 0.03
    np.testing.assert_allclose(got, want, atol=atol)


def test_unet_matches_gan_tpu_with_injected_dropout_masks(monkeypatch):
    """depth 6 (64²) is the smallest U-Net whose up specs keep a dropout
    block; gan_tpu's dropout is replaced by one that takes the same numpy
    masks, in call order, that the port is given."""
    jax_gen, params, gen = _pair(depth=6, seed=1)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    masks = [rng.random((2, 2, 2, 512)) < 0.5 for _ in range(gen.n_dropout)]
    assert gen.n_dropout == 1

    feed = iter(masks)

    def injected_dropout(h, rate, rng_key):
        keep = 1.0 - rate
        return jnp.where(next(feed), h / jnp.asarray(keep, h.dtype), jnp.zeros((), h.dtype))

    monkeypatch.setattr(jax_blocks, "dropout", injected_dropout)
    want = np.asarray(jax_gen.apply(params, jnp.asarray(x), rng=jax.random.PRNGKey(0)))
    with pytest.raises(StopIteration):
        next(feed)   # gan_tpu consumed every mask
    with torch.no_grad():
        got = gen(torch.from_numpy(x), masks=[torch.from_numpy(m) for m in masks]).numpy()
        no_drop = gen(torch.from_numpy(x)).numpy()
    # fp32, as in the dropout-free case
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(got - no_drop).max() > 1e-2   # the masks did change the output


def test_dropout_generator_is_deterministic():
    _, _, gen = _pair(depth=6, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32))
    with torch.no_grad():
        a = gen(x, generator=torch.Generator().manual_seed(5))
        b = gen(x, generator=torch.Generator().manual_seed(5))
        c = gen(x, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3


def test_transplant_round_trip():
    _, params, gen = _pair(depth=5, seed=3)
    back = state_dict_to_params(gen.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert gen.down_1.conv.shape == (128, 64, 4, 4)          # OIHW
    assert gen.up_0.conv.shape == (512, 512, 4, 4)           # (C_in, C_out, k, k)
    assert gen.last.conv.shape == (128, 1, 4, 4)


def test_batch_norm_is_not_ported():
    with pytest.raises(NotImplementedError):
        UNetGenerator(1, 1, norm="batch", depth=5)
