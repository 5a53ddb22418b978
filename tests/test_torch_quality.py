"""The port's quality scores (gan_tpu_torch/quality.py) and CLI
(gan_tpu_torch/tools/eval_quality.py) against gan_tpu's tools/eval_quality.py
on the CPU: L1, PSNR, SSIM, the Fréchet proxy's features and distance, and
both tools' reports on PNG directories, with ``--target`` (and FID over
random Inception weights) and with ``--pairs``. Inputs come from numpy
seeds; each tolerance is stated beside its assertion."""

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import scipy.linalg  # noqa: F401  loaded before threadpool_limits, so that its BLAS is limited
from PIL import Image
from threadpoolctl import threadpool_limits

from gan_tpu.models import inception as jax_inception
from gan_tpu_torch import quality
from gan_tpu_torch.models import inception
from gan_tpu_torch.tools import eval_quality
from torch_inputs import limit_threads

limit_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "gan_tpu_eval_quality", os.path.join(REPO, "tools", "eval_quality.py"))
jax_eval = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_eval)


def _images(seed, n=3, size=32, c=1):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, size, size, c)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("c", [1, 3])
def test_scores_match_gan_tpu(c):
    """fp32 means in other orders: L1 and PSNR 1e-6 relative; SSIM, the
    port's tf.image.ssim against gan_tpu's, 1e-5 absolute; the proxy's
    features, three fp32 convs and a projection from the same draws, 1e-5
    relative to the largest; the Fréchet distance, the same float64 code on
    those features, 1e-5 relative."""
    a, b = _images(c, n=6, c=c)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(quality.l1(ta, tb), jax_eval.l1(a, b), rtol=1e-6)
    np.testing.assert_allclose(quality.psnr(ta, tb), jax_eval.psnr(a, b), rtol=1e-6)
    np.testing.assert_allclose(quality.ssim(ta, tb), jax_eval.ssim_np(a, b), rtol=0, atol=1e-5)
    fa, fb = quality.random_features(ta), quality.random_features(tb)
    want_a, want_b = jax_eval._random_features(a), jax_eval._random_features(b)
    assert fa.shape == want_a.shape == (6, 256)
    for got, want in ((fa, want_a), (fb, want_b)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(quality.frechet_distance(fa, fb),
                               jax_eval.frechet_distance(want_a, want_b), rtol=1e-5)
    np.testing.assert_allclose(quality.frechet_distance(fa, fb),
                               jax_eval.frechet_distance(fa, fb), rtol=1e-12)


def _write(d, arrays, names, *, pair_with=None):
    """[-1, 1] arrays as uint8 PNGs; ``pair_with`` puts each beside a
    second array, left | right, as a Pix2Pix pair."""
    os.makedirs(d, exist_ok=True)
    for i, name in enumerate(names):
        img = arrays[i] if pair_with is None else np.concatenate([pair_with[i], arrays[i]], 1)
        u8 = np.clip((img[..., 0] + 1.0) * 127.5, 0, 255).astype(np.uint8)
        Image.fromarray(u8, "L").save(os.path.join(d, name))


def _report(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["target", "pairs"])
def test_main_matches_gan_tpu(tmp_path, mode):
    # one BLAS thread: among a parallel run's busy workers, scipy's sqrtm of
    # a 2048² product took 44 s threaded and 15 s on one thread
    with threadpool_limits(limits=1, user_api="blas"):
        _main_matches_gan_tpu(tmp_path, mode)


def _main_matches_gan_tpu(tmp_path, mode):
    """Both tools on the same PNGs at --img-size 32 (the 40² files
    nearest-resized): the same keys, n_images equal, and the values as in
    test_scores_match_gan_tpu, the Fréchet proxy over 4 images 1e-4 relative
    (a rank-3 covariance product through sqrtm). With --pairs the generated
    files match pairs by stem: one generated file has no pair.

    With --target the port also computes FID over a random-weight Inception
    (4 images a side). gan_tpu's extractor pads each chunk to 16 and
    compiles anew per call, so the reference is gan_tpu's pool3 on the same
    .npz through its prepare_images, and its frechet_distance: 1e-4 relative
    (features within 1e-5 of each other, a rank-3 product through sqrtm)."""
    gen, tar = _images(7, n=4, size=40)
    names = [f"im{i}.png" for i in range(4)]
    _write(tmp_path / "gen", gen, names)
    argv = ["--generated", str(tmp_path / "gen"), "--img-size", "32"]
    if mode == "target":
        _write(tmp_path / "tar", tar, names)
        argv += ["--target", str(tmp_path / "tar")]
    else:
        _write(tmp_path / "pairs", tar, names[:3], pair_with=gen)
        argv += ["--pairs", str(tmp_path / "pairs")]
    want = _report(jax_eval.main, argv)
    extra = []
    if mode == "target":
        npz = str(tmp_path / "iv3.npz")
        inception.save_params(inception.random_params(3), npz)
        extra = ["--fid-weights", npz]
    got = _report(eval_quality.main, argv + extra)
    assert set(got) == set(want) | ({"fid"} if extra else set())
    assert got["n_images"] == want["n_images"] == (4 if mode == "target" else 3)
    for k in ("l1", "psnr_db"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["frechet_proxy"], want["frechet_proxy"], rtol=1e-4)
    if extra:
        loaded = [jax_eval._load_dir(str(tmp_path / d), 1, 32) for d in ("gen", "tar")]
        feats = np.asarray(jax.jit(jax_inception.inception_v3_pool3)(
            jax_inception.load_params(npz),
            jnp.asarray(jax_inception.prepare_images(np.concatenate(loaded)))))
        fid = jax_eval.frechet_distance(feats[:4], feats[4:])
        assert np.isfinite(got["fid"]) and fid > 0
        np.testing.assert_allclose(got["fid"], fid, rtol=1e-4)
