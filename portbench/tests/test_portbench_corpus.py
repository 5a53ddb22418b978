"""The file cells' corpus: the pool and the PNG writer are a function of the
spec alone, a cut write is redone, the seed draws the split, and the
reference's decoder reads back the pixels that the program's native decoder
and the PIL twin read."""

import os

import numpy as np
import pytest

from portbench import cells, corpus
from portbench.reference import png
from portbench_cases import tiny

SPEC = {"files": 6, "width": 80, "height": 32, "seed": 5, "zlib_level": 6}


def test_the_writer_is_deterministic_and_decodes_back(tmp_path):
    pixels = corpus.pair_pixels(5, 3, 32, 80)
    assert np.array_equal(pixels, corpus.pair_pixels(5, 3, 32, 80))
    assert not np.array_equal(pixels, corpus.pair_pixels(5, 4, 32, 80))
    data = corpus.encode_grey(pixels, 6)
    assert data == corpus.encode_grey(pixels, 6)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    assert np.array_equal(png.decode_grey(str(path)), pixels)


def test_every_filter_decodes(tmp_path):
    """The reference decoder's Avg and Paeth rows too (the writer uses None,
    Sub and Up), through the repository's own PNG writer for the tests."""
    import sys
    sys.path.insert(0, os.path.join(cells.REPO, "tests"))
    from torch_inputs import write_png
    pixels = np.random.default_rng(1).integers(0, 256, (10, 13, 1), dtype=np.uint8)
    path = write_png(str(tmp_path / "f.png"), pixels, color=0, depth=8, filters=(0, 1, 2, 3, 4))
    assert np.array_equal(png.decode_grey(path), pixels[..., 0])


def test_the_pool_is_written_once_and_a_cut_write_is_redone(pool):
    paths = corpus.pair_pool(SPEC)
    assert [os.path.basename(p) for p in paths] == [f"{i:05d}.png" for i in range(6)]
    stamp = os.path.getmtime(paths[0])
    again = corpus.pair_pool(SPEC)
    assert again == paths and os.path.getmtime(paths[0]) == stamp
    cut = pool / "pairs-80x32-7-seed5.partial"
    cut.mkdir()
    (cut / "00000.png").write_bytes(b"half")
    seven = corpus.pair_pool(dict(SPEC, files=7))
    assert len(seven) == 7 and not os.path.exists(cut)
    assert np.array_equal(png.decode_grey(seven[0]), corpus.pair_pixels(5, 0, 32, 80))


def test_the_seed_draws_the_split(pool):
    paths = corpus.pair_pool(SPEC)
    a = corpus.split(paths, 4, 2, seed=1)
    assert a == corpus.split(paths, 4, 2, seed=1)
    assert a != corpus.split(paths, 4, 2, seed=2)
    assert sorted(a[0] + a[1]) == sorted(paths)


def test_the_references_rows_are_the_programs(pool, monkeypatch):
    """pair_row (the reference) against the program's Rows, native and PIL."""
    from gan_tpu_torch.data import native, pipeline
    cell = tiny("pix2pix-512.b4.files")
    train, _val = cells.file_lists(cell, 9)
    want = np.stack([png.pair_row(p, 62) for p in train[:5]])
    rows = pipeline.pix2pix_rows(img_size=32, channels=1, orient="left", train=True)
    try:
        native.build()
    except native.NativeBuildError as e:
        pytest.skip(f"the native decoder does not build here: {e}")
    assert np.array_equal(rows(train[:5]), want)
    monkeypatch.setenv("GAN_TPU_NATIVE", "0")
    assert np.array_equal(rows(train[:5]), want)
