"""The port's InceptionV3 pool3 extractor (gan_tpu_torch/models/inception.py)
against gan_tpu's (gan_tpu/models/inception.py) on the CPU, at random
weights drawn from a numpy seed (BN variances positive) and written once to
an ``.npz`` that both packages load: pool3 features at 75² (the smallest
input the architecture takes) and 299², the weights file in both
directions, ``prepare_images`` on upscale, downscale and 299², and
``extract_features`` at two chunk sizes. Each tolerance is stated beside its
assertion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_tpu.models import inception as jax_inception
from gan_tpu_torch.models import inception
from torch_inputs import limit_threads

limit_threads()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """An .npz written by gan_tpu's save_params: He-scaled conv weights,
    BN shifts and means ~ N(0, 0.1²), variances ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(0)
    params = []
    for block in inception.InceptionV3().blocks:
        c_out, c_in, kh, kw = block.w.shape
        params.append({"w": rng.normal(0, (2.0 / (kh * kw * c_in)) ** 0.5,
                                       (kh, kw, c_in, c_out)).astype(np.float32),
                       "beta": rng.normal(0, 0.1, c_out).astype(np.float32),
                       "mean": rng.normal(0, 0.1, c_out).astype(np.float32),
                       "var": rng.uniform(0.5, 1.5, c_out).astype(np.float32)})
    path = str(tmp_path_factory.mktemp("iv3") / "iv3.npz")
    jax_inception.save_params(params, path)
    return path


def test_architecture_has_keras_sizes():
    """keras' InceptionV3(include_top=False): 21,802,784 weights, of which
    34,432 are the non-trainable BN means and variances (2 × 17,216 channels)."""
    blocks = inception.InceptionV3().blocks
    assert len(blocks) == inception.N_CONV_BN == jax_inception.N_CONV_BN
    assert inception.BN_EPS == jax_inception.BN_EPS
    assert sum(t.numel() for t in inception.InceptionV3().buffers()) == 21_802_784
    assert sum(b.mean.numel() + b.var.numel() for b in blocks) == 34_432


@pytest.mark.parametrize("n, size", [(2, 75), (1, 299)], ids=["75", "299"])
def test_pool3_matches_gan_tpu(weights, n, size):
    """fp32 on both sides, 94 convs summed in other orders: within 1e-5 of
    the largest feature (seen 1.2e-6 at 75², 4e-7 at 299²)."""
    x = np.random.default_rng(size).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_inception.inception_v3_pool3)(
        jax_inception.load_params(weights), jnp.asarray(x)))
    model = inception.load_params(weights)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (n, 2048) and np.isfinite(got).all()
    assert np.abs(want).max() > 0.1   # the random network carries signal to pool3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_weights_file_serves_both_packages(weights, tmp_path):
    """The port reads gan_tpu's file; gan_tpu reads the port's: equal arrays,
    HWIO in the file, OIHW in the module."""
    params = jax_inception.load_params(weights)
    model = inception.load_params(weights)
    for block, p in zip(model.blocks, params):
        np.testing.assert_array_equal(block.w.numpy(), np.asarray(p["w"]).transpose(3, 2, 0, 1))
        for k in ("beta", "mean", "var"):
            np.testing.assert_array_equal(getattr(block, k).numpy(), np.asarray(p[k]))
    path = str(tmp_path / "port.npz")
    inception.save_params([{k: np.asarray(v) for k, v in p.items()} for p in params], path)
    for a, b in zip(jax_inception.load_params(path), params):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("c, size", [(1, 256), (3, 512), (3, 299), (1, 64)],
                         ids=["gray-256-up", "rgb-512-down", "rgb-299", "gray-64-up"])
def test_prepare_images_matches_gan_tpu(c, size):
    """jax.image.resize's half-pixel bilinear (upscale) and its antialiased
    triangle (downscale) against F.interpolate's: 1e-5 (seen 1.2e-7 up,
    2.9e-6 down); 299² passes as it is."""
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, c)).astype(np.float32)
    want = jax_inception.prepare_images(x)
    got = inception.prepare_images(x).numpy()
    assert got.shape == want.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if size == 299:
        np.testing.assert_array_equal(got, x)


def test_extract_features_does_not_depend_on_the_chunk(weights):
    """3 gray 32² images in chunks of 2 (the last of 1, not padded) and in
    one chunk: each image goes alone through inference-mode BN, so only the
    CPU convolution's choice of algorithm per batch size may differ (1e-5 of
    the largest feature; seen 0)."""
    model = inception.load_params(weights)
    x = np.random.default_rng(5).uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    a = inception.extract_features(model, x, batch=2)
    b = inception.extract_features(model, x, batch=16)
    assert a.shape == (3, 2048) and a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
