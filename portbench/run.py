"""One run of one cell of BENCHMARK.json, printing one JSON line last:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout that holds the program (gan_tpu_torch)
beside this folder, on a machine with the CUDA device(s) the cell asks for;
elsewhere it exits with a code other than 0 and prints no result.
"""

import time

T0 = time.perf_counter()   # set-up is counted from here

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# build and kernel caches stay at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(HERE, "cache", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, "cache", "triton"))
os.environ.setdefault("USE_FLAX", "0")
# the package by its name, and none of its modules under a bare name (trace.py, ...)
sys.path = [os.path.dirname(HERE)] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
