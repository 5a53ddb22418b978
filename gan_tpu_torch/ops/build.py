"""Build the port's CUDA kernels into a plain-C shared library.

``nvcc`` compiles every ``gan_tpu_torch/csrc/*.cu`` for ``sm_90a`` into one
``.so`` with a C interface, which :mod:`gan_tpu_torch.ops.kernels` loads with
``ctypes``. The library lands in ``gan_tpu_torch/build/`` (git-ignored) under
a name keyed by a hash of the sources and flags, so a second run reuses it and
an edited source rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", name)


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libgan_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the kernels if the hashed library is missing.

    Returns (library path, seconds spent compiling; 0.0 when reused). The
    compiler's output, ptxas register and shared-memory counts included, is
    kept beside the library as ``<library>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in sources() if s.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        with open(path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)   # atomic: a reader never sees a half-written .so
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0
