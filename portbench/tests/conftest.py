"""The benchmark's CPU tests: the port runs on the CPU (``GAN_TPU_PLATFORM``),
at 32x32 (``GAN_TPU_ALLOW_ANY_SIZE``), on a few torch threads, and a file
cell's pool is written under the test's temporary directory. Tests that need
the card are marked ``cuda`` and decide in a fixture."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("GAN_TPU_PLATFORM", "cpu")
os.environ.setdefault("GAN_TPU_ALLOW_ANY_SIZE", "1")

import torch  # noqa: E402

torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // 2)))


@pytest.fixture
def pool(tmp_path, monkeypatch):
    from portbench import corpus
    monkeypatch.setattr(corpus, "CACHE", str(tmp_path / "corpus"))
    return tmp_path / "corpus"


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card with -m cuda)")
    return torch.device("cuda")
