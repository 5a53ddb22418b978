"""ctypes bindings of the port's native host loader (``decoder.cpp``), and its build
(counterpart of gan_tpu/data/native/).

One call decodes a list of PNG files and does their per-file work (the
Pix2Pix split and resizes, CycleGAN's resizes, or pix2pixHD's label,
instance and image maps of one row) into a caller's uint8
array, spread over ``threads`` C++ threads. ctypes releases the GIL for the
whole call, so the main thread keeps launching the card's work meanwhile.
The rows equal gan_tpu's default (native) path bit for bit.

The decoder is PNG only and needs only zlib. A JPEG (a file that starts
with FF D8) comes back marked, and :class:`gan_tpu_torch.data.pipeline.Rows`
decodes it with PIL. Any other failure raises :class:`DecodeError`, which
names the file and the reason.

The library is built at first use, never at import: ``$CXX`` (default
``g++``) compiles ``decoder.cpp`` with ``FLAGS`` into
``gan_tpu_torch/build/``, under a name keyed by a hash of the source, the
compiler and the flags, and is moved into place atomically, so concurrent
processes never see half a library. A failed build raises
:class:`NativeBuildError` with the compiler's output. Nothing falls back:
``GAN_TPU_NATIVE=0`` is the one way to decode with PIL instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")

# decoder.cpp's statuses
OK, JPEG = 0, 3
REASONS = {1: "cannot open or read the file", 2: "not a PNG (nor a JPEG)", 3: "a JPEG",
           4: "bad CRC", 5: "truncated data", 6: "unsupported form", 7: "corrupt data",
           8: "out of memory", 9: "buffer too small"}

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """The decoder did not build."""


class DecodeError(OSError):
    """A file the native decoder refused: not a JPEG, and not a PNG it decodes."""


def enabled() -> bool:
    """Native decode unless ``GAN_TPU_NATIVE=0`` (gan_tpu's switch, read at each call)."""
    return os.environ.get("GAN_TPU_NATIVE") != "0"


def default_threads(share: int = 1) -> int:
    """Decode threads per call: every core this process may run on (its CPU
    affinity, which a container's CPU set narrows; ``os.cpu_count()`` where
    the platform does not report it), divided among ``share`` processes
    that decode on the same host (data-parallel ranks). On the H100's 8-core host
    (chip_smoke.py phase 13) 8 threads decoded the reference corpus's
    1280x512 pair files 11.3% faster than 7, where decode is what a
    streamed epoch waits for. At 512x256 files the readings went both ways
    (8 threads +13.6% and +32.6% in two runs, -6.4% in a third), and the
    streamed epochs of both models ran alike with either.
    The decode holds no GIL, so the main thread that launches the graph
    replays competes for a core only, not for the interpreter."""
    try:
        cores = len(os.sched_getaffinity(0)) or 1
    except AttributeError:   # no affinity on this platform
        cores = os.cpu_count() or 1
    return max(1, cores // share)


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> str:
    h = hashlib.sha256(" ".join((compiler(),) + FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgtt_loader_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the decoder if the hashed library is missing. Returns (its
    path, seconds spent compiling; 0.0 when reused)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler(), *FLAGS, "-o", tmp, SOURCE, *LIBS]
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            output, failed = proc.stdout + proc.stderr, proc.returncode != 0
        except OSError as e:   # no such compiler
            output, failed = str(e), True
        if failed:
            raise NativeBuildError(
                f"building the native PNG decoder failed: {' '.join(cmd)}\n{output}\n"
                "It needs a C++17 compiler ($CXX, default g++) and zlib's headers; "
                "GAN_TPU_NATIVE=0 decodes with PIL instead.")
        os.replace(tmp, path)   # atomic: a reader never sees a half-written library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The decoder, built and loaded on first use. ``CDLL``, not ``PyDLL``:
    its calls release the GIL."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()[0])
            u8, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
            paths, c_int = ctypes.POINTER(ctypes.c_char_p), ctypes.c_int
            lib.gtt_load_pair_batch.argtypes = [paths, c_int, c_int, c_int, c_int, u8, c_int, i32]
            lib.gtt_load_single_batch.argtypes = [paths, c_int, c_int, c_int, c_int, u8, c_int,
                                                  i32]
            lib.gtt_load_hd_batch.argtypes = [paths, paths, paths, c_int, c_int, c_int, u8, c_int,
                                              i32]
            lib.gtt_decode.argtypes = [ctypes.c_char_p, c_int, u8, ctypes.c_longlong, i32, i32]
            for fn in (lib.gtt_load_pair_batch, lib.gtt_load_single_batch, lib.gtt_load_hd_batch,
                       lib.gtt_decode):
                fn.restype = c_int
            _lib = lib
        return _lib


def _error(path: str, status: int) -> DecodeError:
    return DecodeError(f"native PNG decoder: {path}: {REASONS.get(status, f'status {status}')}")


def _out(out: Optional[np.ndarray], shape: tuple) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.uint8)
    if out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of {shape}, "
                         f"not {out.dtype} {out.shape}")
    return out


def _run(fn, paths: Sequence[str], out: np.ndarray, args: tuple,
         threads: Optional[int]) -> list[int]:
    """Calls a batch entry point; returns the indices of the JPEG files
    (their rows left unwritten) and raises on any other failure."""
    n = len(paths)
    if n == 0:
        return []
    names = (ctypes.c_char_p * n)(*(os.fsencode(p) for p in paths))
    status = np.zeros(n, np.int32)
    failed = fn(names, n, *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                threads or default_threads(),
                status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if failed:
        raise _error(paths[failed - 1], int(status[failed - 1]))
    return np.flatnonzero(status == JPEG).tolist()


def load_pair_batch(paths: Sequence[str], *, channels: int, orient: str, size: int,
                    out: Optional[np.ndarray] = None,
                    threads: Optional[int] = None) -> tuple[np.ndarray, list[int]]:
    """(N, 2, size, size, C) uint8, axis 1 = (input, target), and the
    indices of the JPEG files, whose rows are left to the caller: the
    native twin of ``pipeline.pix2pix_sample`` over the files."""
    out = _out(out, (len(paths), 2, size, size, channels))
    jpegs = _run(library().gtt_load_pair_batch, paths, out,
                 (channels, 1 if orient == "left" else 0, size), threads)
    return out, jpegs


def load_single_batch(paths: Sequence[str], *, channels: int, img_size: int, out_size: int,
                      out: Optional[np.ndarray] = None,
                      threads: Optional[int] = None) -> tuple[np.ndarray, list[int]]:
    """(N, out_size, out_size, C) uint8 and the indices of the JPEG files:
    the native twin of ``pipeline.cyclegan_sample`` over the files (resized
    to ``img_size``, then to ``out_size`` when they differ)."""
    out = _out(out, (len(paths), out_size, out_size, channels))
    jpegs = _run(library().gtt_load_single_batch, paths, out,
                 (channels, img_size, out_size), threads)
    return out, jpegs


def load_hd_batch(triples: Sequence[tuple], *, height: int, width: int,
                  out: Optional[np.ndarray] = None,
                  threads: Optional[int] = None) -> tuple[np.ndarray, list[int]]:
    """(N, height, width, 6) uint8 pix2pixHD rows of (label, instance, image)
    file triples, the instance or image None where there is none, and the
    indices of the rows with a JPEG among their files: the native twin of
    ``pipeline.pix2pixhd_sample``."""
    n = len(triples)
    out = _out(out, (n, height, width, 6))
    if n == 0:
        return out, []
    names = [(ctypes.c_char_p * n)(*(None if t[k] is None else os.fsencode(t[k])
                                     for t in triples)) for k in range(3)]
    status = np.zeros(n, np.int32)
    failed = library().gtt_load_hd_batch(
        *names, n, height, width, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads or default_threads(), status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if failed:
        raise _error(", ".join(p for p in triples[failed - 1] if p), int(status[failed - 1]))
    return out, np.flatnonzero(status == JPEG).tolist()


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR, or (0, 0) when it has none or
    cannot be read (the decoder then says why)."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return 0, 0
    if len(head) < 24 or head[12:16] != b"IHDR":
        return 0, 0
    return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")


def decode_image(path: str, channels: int) -> np.ndarray:
    """One PNG as uint8 (H, W, channels): the native twin of
    ``pipeline.decode_image``."""
    h, w = png_size(path)
    out = np.empty((h, w, channels), np.uint8)
    got_h, got_w = ctypes.c_int(0), ctypes.c_int(0)
    status = library().gtt_decode(os.fsencode(path), channels,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
                                  ctypes.byref(got_h), ctypes.byref(got_w))
    if status != OK:
        raise _error(path, status)
    return out
