"""The port's host-data layer against gan_tpu's (counterpart of
tests/test_loader.py and tests/test_pipelined_map.py): FileCache batches
byte for byte on the same seeded PNGs and orders, the per-file
preprocessors, ``host_cache_fits``' decisions, the device plan, and
``prefetch_iter``'s order, errors, passthrough and release of its producer.

Both packages' pipelines run their PIL paths (``GAN_TPU_NATIVE=0``, one
switch for both): gan_tpu's native loader would be built by ``make`` on
first use, and the port's native decoder is held to both packages in
tests/test_torch_native.py."""

import gc
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from gan_tpu.data import loader as jax_loader
from gan_tpu.data import pipeline as jax_pipeline
from gan_tpu_torch.data import loader, pipeline
from torch_inputs import limit_threads

limit_threads()

SIZE = 32
KINDS = ["pix2pix", "cyclegan"]


@pytest.fixture(autouse=True)
def _python_decode(monkeypatch):
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")


def _pngs(root, kind: str, n: int = 7) -> list[str]:
    rng = np.random.default_rng(11)
    shape = (SIZE + 8, 2 * SIZE + 6) if kind == "pix2pix" else (SIZE + 5, SIZE + 9)
    paths = []
    for i in range(n):
        path = str(root / f"{kind}_{i}.png")
        Image.fromarray(rng.integers(0, 256, (*shape, 3), np.uint8), "RGB").save(path)
        paths.append(path)
    return paths


def _rows(kind: str, train: bool, channels: int = 1) -> pipeline.Rows:
    """The port's :class:`pipeline.Rows` of one setting (as its CLIs make them)."""
    kw = dict(img_size=SIZE, channels=channels, train=train)
    if kind == "pix2pix":
        return pipeline.pix2pix_rows(orient="right", **kw)
    return pipeline.cyclegan_rows(**kw)


def _samplers(kind: str, train: bool, channels: int = 1):
    """(the port's per-file sample, gan_tpu's per-file form as its CLI
    builds it, the port's cache builder, gan_tpu's), for one setting."""
    kw = dict(img_size=SIZE, channels=channels, train=train)
    if kind == "pix2pix":
        kw["orient"] = "right"
        return (lambda p: pipeline.pix2pix_sample(p, **kw),
                lambda p: jax_pipeline.build_pix2pix_cache([p], **kw)[0],
                lambda ps: pipeline.build_pix2pix_cache(ps, **kw),
                lambda ps: jax_pipeline.build_pix2pix_cache(ps, **kw))
    return (lambda p: pipeline.cyclegan_sample(p, **kw),
            lambda p: jax_pipeline.build_cyclegan_cache([p], **kw)[0],
            lambda ps: pipeline.build_cyclegan_cache(ps, **kw),
            lambda ps: jax_pipeline.build_cyclegan_cache(ps, **kw))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("kind", KINDS)
def test_per_file_samples_equal_the_cache_rows(tmp_path, kind, train, channels):
    """``pix2pix_sample`` / ``cyclegan_sample`` of each file equal the port's
    ``build_*_cache`` rows, gan_tpu's, and gan_tpu's ``build_*_cache([p])[0]``."""
    paths = _pngs(tmp_path, kind, n=3)
    sample, jax_sample, build, jax_build = _samplers(kind, train, channels)
    rows = np.stack([sample(p) for p in paths])
    assert rows.dtype == np.uint8 and rows.shape[-1] == channels
    np.testing.assert_array_equal(rows, build(paths))
    np.testing.assert_array_equal(rows, jax_build(paths))
    np.testing.assert_array_equal(rows, np.stack([jax_sample(p) for p in paths]))


@pytest.mark.parametrize("rebatch", [None, 3], ids=["own_batch", "rebatched"])
@pytest.mark.parametrize("kind", KINDS)
def test_filecache_batches_equal_gan_tpu(tmp_path, kind, rebatch):
    """The port's FileCache (the CLIs' rows, batch 2) against gan_tpu's
    (``build_*_cache([p])[0]``, as its CLIs build it) over the same PNGs and
    the same permutation, batch by batch and byte for byte; ``rebatched``
    walks both through ``iter_uint8_batches`` at another batch size."""
    paths = _pngs(tmp_path, kind)
    sample, jax_sample, build, _ = _samplers(kind, True)
    shape = sample(paths[0]).shape
    port = loader.FileCache(paths, _rows(kind, True), 2)
    ref = jax_loader.FileCache(paths, jax_sample, shape, 2)
    assert port.shape == ref.shape and port.nbytes == ref.nbytes and len(port) == len(ref)
    order = np.random.default_rng(4).permutation(len(paths))
    if rebatch is None:
        got, want = list(port.epoch(order)), list(ref.epoch(order))
    else:
        got = list(loader.iter_uint8_batches(port, rebatch, order))
        want = list(jax_loader.iter_uint8_batches(ref, rebatch, order))
    ref.close()
    assert [len(b) for b in got] == [len(b) for b in want]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), build(paths)[order])


@pytest.mark.parametrize("mode", ["on", "off"])
def test_host_or_file_cache_decodes_or_streams(tmp_path, capsys, mode):
    """The CLIs' choice: under ``on`` the rows decoded up front (an empty
    split too), under ``off`` a FileCache of the same rows and gan_tpu's
    line."""
    paths = _pngs(tmp_path, "pix2pix", n=3)
    sample, _, build, _ = _samplers("pix2pix", True)
    shape = sample(paths[0]).shape
    rows = _rows("pix2pix", True)
    cache = loader.host_or_file_cache(paths, rows, 2, mode)
    out = capsys.readouterr().out
    if mode == "on":
        assert isinstance(cache, np.ndarray) and "streaming" not in out
        np.testing.assert_array_equal(cache, build(paths))
        assert loader.host_or_file_cache([], rows, 2, mode).shape == (0, *shape)
    else:
        assert isinstance(cache, loader.FileCache) and cache.shape == (3, *shape)
        assert "Host cache disabled for 3 files — streaming from disk." in out
        np.testing.assert_array_equal(np.concatenate(list(cache.epoch())), build(paths))


@pytest.mark.parametrize("order", [None, "perm", "prefix"])
def test_iter_uint8_batches_over_an_array_equals_gan_tpu(order):
    cache = np.random.default_rng(1).integers(0, 256, (11, 4, 4, 1), np.uint8)
    idx = {None: None, "perm": np.random.default_rng(2).permutation(11),
           "prefix": np.arange(3, 11)}[order]
    got = list(loader.iter_uint8_batches(cache, 4, idx))
    want = list(jax_loader.iter_uint8_batches(cache, 4, idx))
    assert [len(b) for b in got] == [len(b) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_host_cache_fits_decides_as_gan_tpu(monkeypatch, mode):
    """Both packages' decisions over a grid of sizes, with MemAvailable
    patched to 8 GiB in both."""
    for module in (loader, jax_loader):
        monkeypatch.setattr(module, "host_ram_available", lambda: 8 << 30)
    for nbytes in (0, 1, (4 << 30) - 1, 4 << 30, (4 << 30) + 1, 8 << 30, 1 << 50):
        want = jax_loader.host_cache_fits(nbytes, mode)
        assert loader.host_cache_fits(nbytes, mode) == want, (nbytes, mode)
        if mode == "auto":
            assert want == (nbytes <= 4 << 30)
    assert loader.host_ram_available() == 8 << 30


def test_device_cache_plan_on_the_cpu():
    """0.4 of gan_tpu's 12 GiB estimate on the CPU; ``off`` streams every
    group, ``on`` keeps every array group resident, ``auto`` keeps the
    largest groups that fit together; a FileCache (None) always streams."""
    cpu = torch.device("cpu")
    budget = int(0.4 * (12 << 30))
    assert loader.device_cache_fits(budget, cpu) and not loader.device_cache_fits(budget + 1, cpu)
    assert loader.plan_cache_storage([10, 20], cpu) == ["resident", "resident"]
    assert loader.plan_cache_storage([10, None], cpu) == ["resident", "stream"]
    assert loader.plan_cache_storage([10, 20], cpu, "off") == ["stream", "stream"]
    assert loader.plan_cache_storage([budget, budget], cpu, "on") == ["resident", "resident"]
    assert loader.plan_cache_storage([budget // 3, budget], cpu) == ["stream", "resident"]
    assert loader.plan_cache_storage([budget + 1, budget // 2], cpu) == ["stream", "resident"]


def _counter():
    i = 0
    while True:
        yield i
        i += 1


def test_prefetch_iter_keeps_order_and_reraises():
    def src():
        yield from range(5)
        raise ValueError("decode failed")

    g = loader.prefetch_iter(src(), depth=2)
    assert [next(g) for _ in range(5)] == list(range(5))
    with pytest.raises(ValueError, match="decode failed"):
        next(g)


def test_prefetch_iter_depth_zero_is_a_passthrough(monkeypatch):
    monkeypatch.setenv("GAN_TPU_PREFETCH_DEPTH", "0")
    before = set(threading.enumerate())
    closed = []

    def src():
        try:
            yield from range(4)
        finally:
            closed.append(True)

    assert list(loader.prefetch_iter(src())) == [0, 1, 2, 3]
    assert set(threading.enumerate()) == before and closed == [True]


@pytest.mark.parametrize("how", ["abandoned", "never_started"])
def test_prefetch_iter_releases_its_producer(how):
    """A consumer that closes the generator mid-way, or drops it before its
    first item, ends the producer, which closes its source: otherwise the
    producer would block on the full queue for good."""
    closed = threading.Event()

    def src():
        try:
            yield from _counter()
        finally:
            closed.set()

    before = set(threading.enumerate())
    g = loader.prefetch_iter(src(), depth=1)
    (producer,) = [t for t in threading.enumerate() if t not in before]
    if how == "abandoned":
        assert next(g) == 0
        g.close()
    else:
        del g
        gc.collect()
    producer.join(timeout=5.0)
    assert not producer.is_alive() and closed.is_set()


def test_filecache_epoch_threads_end_with_the_epoch(tmp_path):
    """A FileCache starts no thread until its epoch's first batch, and its
    producer and the rows' pool end when the epoch is exhausted, closed
    mid-way or fails; a decode error re-raises at the consumer."""
    paths = _pngs(tmp_path, "cyclegan", n=5)
    rows = _rows("cyclegan", False)
    sample = rows.sample
    before = set(threading.enumerate())
    fc = loader.FileCache(paths, rows, 2)
    epoch = fc.epoch()
    assert set(threading.enumerate()) == before
    assert [len(b) for b in epoch] == [2, 2, 1]
    assert set(threading.enumerate()) == before
    epoch = fc.epoch()
    next(epoch)
    epoch.close()
    assert set(threading.enumerate()) == before

    def fails(path):
        if path == paths[3]:
            raise OSError("truncated file")
        return sample(path)

    with pytest.raises(OSError, match="truncated file"):
        list(loader.FileCache(paths, pipeline.Rows(fails, rows.shape), 2).epoch())
    assert set(threading.enumerate()) == before
