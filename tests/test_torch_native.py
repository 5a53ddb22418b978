"""The port's native PNG decoder (gan_tpu_torch/data/native) against gan_tpu
on the CPU, bit for bit: every colour type and bit depth, each row filter,
Adam7 and IDAT data over several chunks (files from ``torch_inputs.write_png``),
against gan_tpu's PIL decode and its native (libpng) decode; pair and single
batches against gan_tpu's ``build_*_cache``; 16-bit gray's high byte; the
errors, each naming its file; JPEGs through PIL, counted; and a FileCache
epoch on native decode against the PIL twin's."""

import ctypes
import fcntl
import os
import re
import struct
import subprocess
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from gan_tpu.data import native as jax_native
from gan_tpu.data import pipeline as jax_pipeline
from gan_tpu.data.decode import decode_image as jax_decode_image
from gan_tpu_torch.data import loader, native, pipeline
from torch_inputs import PNG_SAMPLES, PNG_SIGNATURE, limit_threads, png_chunk, write_png

limit_threads()

FILTERS = (0, 1, 2, 3, 4)
# every form PNG allows: (colour type, bit depth, with tRNS)
FORMS = [(0, 1, False), (0, 2, False), (0, 4, False), (0, 8, False), (0, 16, False),
         (2, 8, False), (2, 16, False), (3, 1, False), (3, 2, False), (3, 4, False),
         (3, 8, False), (4, 8, False), (4, 16, False), (6, 8, False), (6, 16, False),
         (0, 8, True), (2, 8, True), (3, 2, True), (3, 8, True)]
FORM_IDS = [f"c{c}d{d}" + ("trns" if t else "") for c, d, t in FORMS]
# gan_tpu's PIL path clips 16-bit gray where its native path keeps the high byte
PIL_FORMS = [f for f in FORMS if f[:2] != (0, 16)]


def _form_png(path: str, color: int, depth: int, trns: bool, interlace: bool,
              shape=(23, 37), seed: int = 0) -> str:
    """A seeded PNG of one form, each row filter in turn, over 3 IDAT chunks."""
    rng = np.random.default_rng(seed + 100 * color + depth)
    palette = None
    if color == 3:
        n = min(1 << depth, 200)
        palette = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, n, (*shape, 1))
    else:
        samples = rng.integers(0, 1 << depth, (*shape, PNG_SAMPLES[color]))
    trns_bytes = None
    if trns:
        trns_bytes = {0: b"\x00\x07", 2: b"\x00\x01\x00\x02\x00\x03",
                      3: bytes(rng.integers(0, 256, 3, np.uint8))}[color]
    return write_png(path, samples, color=color, depth=depth, filters=FILTERS,
                     interlace=interlace, idat_chunks=3, palette=palette, trns=trns_bytes)


@pytest.fixture(scope="module")
def library():
    """The decoder, built once per process (each xdist worker reuses the
    hashed library when another has built it)."""
    return native.library()


@pytest.fixture(scope="module")
def forms(tmp_path_factory, library):
    root = tmp_path_factory.mktemp("forms")
    return {(c, d, t, i): _form_png(str(root / f"c{c}d{d}t{int(t)}i{int(i)}.png"), c, d, t, i)
            for c, d, t in FORMS for i in (False, True)}


def _build_gan_tpu_native() -> None:
    """Builds gan_tpu's native library (``make -C gan_tpu/data/native``)
    under a lock on a file in the port's build directory, so that the xdist
    workers build it one at a time and none loads a half-written library.
    Skips when ``make`` fails (no libpng or libjpeg here); fails when the
    build succeeded but the library does not load."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    with open(os.path.join(native.BUILD_DIR, "gt.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            made = subprocess.run(["make", "-C", os.path.dirname(jax_native._SO)],
                                  capture_output=True, text=True, timeout=300)
            output, failed = made.stdout + made.stderr, made.returncode != 0
        except (OSError, subprocess.TimeoutExpired) as e:
            output, failed = str(e), True
    if failed:
        pytest.skip(f"gan_tpu's native loader does not build here: {output[-500:]}")
    # gan_tpu's own lazy make (its tests, without this lock) may still be
    # writing the file: give it time to finish before calling the load a fault
    for attempt in range(30):
        try:
            ctypes.CDLL(jax_native._SO)
            break
        except OSError:
            if attempt == 29:
                raise
            time.sleep(1.0)
    if not jax_native.available():
        # an earlier load in this process raced that make and gave up for good
        jax_native._tried = False
        assert jax_native.available(), "gan_tpu's native loader built but does not load"


@pytest.fixture(scope="module")
def gan_tpu_native():
    """gan_tpu's native (libpng) decode of one file, ``gt_decode``
    (gan_tpu/data/native/decoder.cpp:275); gan_tpu's default path, which
    ``jax_pipeline.build_*_cache`` takes from here on."""
    _build_gan_tpu_native()
    lib = ctypes.CDLL(jax_native._SO)
    lib.gt_decode.restype = ctypes.c_int
    lib.gt_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]

    def decode(path: str, channels: int) -> np.ndarray:
        buf = np.empty(1 << 20, np.uint8)
        h, w = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.gt_decode(path.encode(), channels,
                           buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
                           ctypes.byref(h), ctypes.byref(w))
        assert rc == 0, (path, rc)
        return buf[:h.value * w.value * channels].reshape(h.value, w.value, channels)

    return decode


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("form", PIL_FORMS, ids=[i for f, i in zip(FORMS, FORM_IDS)
                                                 if f in PIL_FORMS])
def test_native_decode_equals_gan_tpu_pil(forms, form, interlace, channels):
    """The native decode of each form equals gan_tpu's PIL decode and the
    port's PIL twin, byte for byte."""
    path = forms[(*form, interlace)]
    got = native.decode_image(path, channels)
    assert got.dtype == np.uint8 and got.shape == (23, 37, channels)
    np.testing.assert_array_equal(got, jax_decode_image(path, channels))
    np.testing.assert_array_equal(got, pipeline.decode_image(path, channels))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_native_decode_equals_gan_tpu_native(forms, gan_tpu_native, form, interlace):
    """Every form, 16-bit gray too, in both channel counts, against
    gan_tpu's native decoder (libpng), byte for byte."""
    path = forms[(*form, interlace)]
    for channels in (1, 3):
        np.testing.assert_array_equal(native.decode_image(path, channels),
                                      gan_tpu_native(path, channels))


@pytest.mark.parametrize("shape", [(1, 1), (1, 6), (3, 2), (9, 1), (8, 8)])
def test_small_adam7_images(tmp_path, library, gan_tpu_native, shape):
    """Images with empty Adam7 passes, 8-bit gray and 2-bit palette."""
    for color, depth in ((0, 8), (3, 2)):
        path = _form_png(str(tmp_path / f"{color}.png"), color, depth, False, True, shape=shape)
        for channels in (1, 3):
            got = native.decode_image(path, channels)
            np.testing.assert_array_equal(got, jax_decode_image(path, channels))
            np.testing.assert_array_equal(got, gan_tpu_native(path, channels))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_sixteen_bit_gray_keeps_the_high_byte(tmp_path, library, gan_tpu_native, interlace):
    """A 16-bit gray ramp 0, 16, 32, ...: the high byte (0 ... 255) in the
    native decoder, in the port's PIL twin (PIL's ``convert("L")`` clips it
    to 0, 16, 32, ..., 255) and in gan_tpu's native path."""
    ramp = (np.arange(64 * 64, dtype=np.uint16) * 16).reshape(64, 64, 1)
    want = (ramp >> 8).astype(np.uint8)
    path = write_png(str(tmp_path / "ramp.png"), ramp, color=0, depth=16, filters=FILTERS,
                     interlace=interlace, idat_chunks=2)
    saved = str(tmp_path / "pil.png")   # as PIL writes it (I;16)
    Image.fromarray(ramp[:, :, 0]).save(saved)
    for p in (path, saved):
        for channels in (1, 3):
            want_c = np.repeat(want, channels, axis=2)
            np.testing.assert_array_equal(native.decode_image(p, channels), want_c)
            np.testing.assert_array_equal(pipeline.decode_image(p, channels), want_c)
            np.testing.assert_array_equal(gan_tpu_native(p, channels), want_c)


def _corpus(root, pair: bool, n: int = 4) -> list[str]:
    """Gray and RGB 8-bit PNGs as PIL writes them, and an Adam7 palette PNG."""
    rng = np.random.default_rng(3)
    shape = (40, 70) if pair else (37, 45)
    paths = []
    for i in range(n):
        mode, dims = ("L", shape) if i % 2 else ("RGB", (*shape, 3))
        paths.append(str(root / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, dims, np.uint8), mode).save(paths[-1])
    paths.append(_form_png(str(root / "palette.png"), 3, 4, True, True, shape=shape))
    return paths


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("orient", ["left", "right"])
@pytest.mark.parametrize("channels", [1, 3])
def test_pair_batches_equal_gan_tpu(tmp_path, monkeypatch, library, gan_tpu_native, channels,
                                   orient, train):
    """``build_pix2pix_cache`` on native decode against gan_tpu's default
    path (its native loader, built by the fixture) and, under
    ``GAN_TPU_NATIVE=0``, both packages' PIL paths."""
    paths = _corpus(tmp_path, pair=True)
    kw = dict(img_size=16, channels=channels, orient=orient, train=train)
    got = pipeline.build_pix2pix_cache(paths, **kw)
    size = 16 + 30 if train else 16
    assert got.shape == (len(paths), 2, size, size, channels)
    np.testing.assert_array_equal(got, jax_pipeline.build_pix2pix_cache(paths, **kw))
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")
    np.testing.assert_array_equal(got, pipeline.build_pix2pix_cache(paths, **kw))
    np.testing.assert_array_equal(got, jax_pipeline.build_pix2pix_cache(paths, **kw))


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("channels", [1, 3])
def test_single_batches_equal_gan_tpu(tmp_path, monkeypatch, library, gan_tpu_native, channels,
                                     train):
    """``build_cyclegan_cache`` (two chained resizes for train) likewise."""
    paths = _corpus(tmp_path, pair=False)
    kw = dict(img_size=16, channels=channels, train=train)
    got = pipeline.build_cyclegan_cache(paths, **kw)
    np.testing.assert_array_equal(got, jax_pipeline.build_cyclegan_cache(paths, **kw))
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")
    np.testing.assert_array_equal(got, pipeline.build_cyclegan_cache(paths, **kw))
    np.testing.assert_array_equal(got, jax_pipeline.build_cyclegan_cache(paths, **kw))


def test_threads_and_a_given_buffer(tmp_path, library):
    """The rows do not depend on the thread count (1, 3, more than files),
    land in a buffer the caller passes, and a wrong buffer is refused."""
    paths = _corpus(tmp_path, pair=True, n=7)
    kw = dict(channels=1, orient="left", size=20)
    one, jpegs = native.load_pair_batch(paths, threads=1, **kw)
    assert jpegs == []
    for threads in (3, 32):
        out = np.zeros((len(paths), 2, 20, 20, 1), np.uint8)
        got, _ = native.load_pair_batch(paths, out=out, threads=threads, **kw)
        assert got is out
        np.testing.assert_array_equal(out, one)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.load_pair_batch(paths, out=np.zeros((len(paths), 2, 20, 20, 1), np.int16), **kw)


def _bad_file(root, case: str) -> str:
    """A file the decoder must refuse, and its reason."""
    good = _form_png(str(root / "good.png"), 0, 8, False, False)
    with open(good, "rb") as f:
        data = bytearray(f.read())
    idat = data.index(b"IDAT")
    path = str(root / f"{case}.png")
    if case == "bad_crc":
        data[idat + 8] ^= 0xFF   # a byte of the first IDAT's data, its CRC left as it was
    elif case == "truncated_idat":   # valid chunks around half of the zlib stream
        rows = np.random.default_rng(9).integers(0, 256, (23, 38), np.uint8)
        rows[:, 0] = 0   # filter None
        stream = zlib.compress(rows.tobytes())
        data = (PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", 37, 23, 8, 0, 0, 0, 0))
                + png_chunk(b"IDAT", stream[:len(stream) // 2]) + png_chunk(b"IEND", b""))
    elif case == "truncated_file":
        data = data[:idat + 20]
    elif case == "not_an_image":
        data = bytearray(b"neither a PNG nor a JPEG\n" * 4)
    if case != "missing":
        with open(path, "wb") as f:
            f.write(data)
    return path


@pytest.mark.parametrize("case,reason", [
    ("bad_crc", "bad CRC"), ("truncated_idat", "truncated data"),
    ("truncated_file", "truncated data"), ("not_an_image", "not a PNG"),
    ("missing", "cannot open")])
def test_errors_name_the_file(tmp_path, library, case, reason):
    """Each refused file raises an error that names it and the reason, from
    one file and from a batch (its other files fine)."""
    bad = _bad_file(tmp_path, case)
    good = str(tmp_path / "good.png")
    with pytest.raises(native.DecodeError, match=re.escape(bad) + ".*" + reason):
        native.decode_image(bad, 1)
    for rows in (pipeline.cyclegan_rows(img_size=8, channels=1),
                 pipeline.pix2pix_rows(img_size=8, channels=3, orient="left", train=True)):
        with pytest.raises(OSError, match=re.escape(bad) + ".*" + reason):
            rows([good, good, bad, good])


def test_jpeg_goes_through_pil_and_is_counted(tmp_path, monkeypatch, library):
    """A JPEG among PNGs: the native call leaves its row to the PIL twin,
    which fills it, and the rows count it; the batch equals the PIL twin's."""
    paths = _corpus(tmp_path, pair=True, n=3)
    jpg = str(tmp_path / "photo.jpg")
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (40, 70, 3), np.uint8)).save(jpg)
    paths.insert(1, jpg)
    rows = pipeline.pix2pix_rows(img_size=16, channels=1, orient="left", train=True)
    got = rows(paths)
    assert rows.jpeg_files == 1
    np.testing.assert_array_equal(got[1], pipeline.pix2pix_sample(jpg, img_size=16, channels=1,
                                                                  orient="left", train=True))
    rows([jpg, jpg])
    assert rows.jpeg_files == 3
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")
    twin = pipeline.pix2pix_rows(img_size=16, channels=1, orient="left", train=True)
    np.testing.assert_array_equal(got, twin(paths))
    assert twin.jpeg_files == 0   # the twin decodes every file with PIL: none is set apart


@pytest.mark.parametrize("kind", ["pix2pix", "cyclegan"])
def test_filecache_epoch_on_native_decode(tmp_path, monkeypatch, library, kind):
    """A FileCache epoch (batch 2, a permutation) on native decode equals
    the same epoch on the PIL twin, and ``build_*_cache``'s rows."""
    paths = _corpus(tmp_path, pair=kind == "pix2pix", n=6)
    if kind == "pix2pix":
        make = lambda: pipeline.pix2pix_rows(img_size=16, channels=1, orient="right", train=True)
        build = lambda: pipeline.build_pix2pix_cache(paths, img_size=16, channels=1,
                                                     orient="right", train=True)
    else:
        make = lambda: pipeline.cyclegan_rows(img_size=16, channels=1, train=True)
        build = lambda: pipeline.build_cyclegan_cache(paths, img_size=16, channels=1, train=True)
    order = np.random.default_rng(2).permutation(len(paths))
    got = list(loader.FileCache(paths, make(), 2).epoch(order))
    assert [len(b) for b in got] == [2, 2, 2, 1]
    np.testing.assert_array_equal(np.concatenate(got), build()[order])
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")
    twin = list(loader.FileCache(paths, make(), 2).epoch(order))
    for g, w in zip(got, twin):
        np.testing.assert_array_equal(g, w)


def test_default_threads_follow_the_affinity(monkeypatch):
    """One decode thread per core this process may run on, which a CPU set
    narrows; ``os.cpu_count()`` where the platform has no affinity."""
    assert native.default_threads() == len(os.sched_getaffinity(0))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 2})
    assert native.default_threads() == 2
    monkeypatch.delattr(os, "sched_getaffinity")
    assert native.default_threads() == os.cpu_count()
