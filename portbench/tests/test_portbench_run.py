"""A run's result line and exits: with the device stubbed by the CPU (the
harness's ``run`` with a CPU device, which the CLI never passes), the line
has exactly the contract's keys, the compared numbers last; without a card
the CLI exits with a code other than 0 and prints no result, also in a
directory that holds only BENCHMARK.json and portbench/; a run that loaded
the JAX package prints none."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness
from portbench_cases import tiny

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")


def stub_run(name, traced, **kw):
    return harness.run(tiny(name, dtype="fp32"), 2**31 + 5, 0.1, traced, CPU,
                       time.perf_counter(), **kw)


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(traced):
    out = stub_run("cyclegan-256.b4.resident", traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if traced else []) + ["checks"]
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert out["device"]["platform"] == "cpu" and out["device"]["memory_peak_bytes"] == 0
    assert set(out["checks"]) == {"loss", "grad1", "grad1_diff", "change", "failed_steps"}
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    if traced:
        assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["metrics"] == {}   # no device here: no device metric is read
    else:
        assert set(out["metrics"]) == {"train_pairs_per_s", "peak_mem_gib", "setup_s"}
        assert out["metrics"]["train_pairs_per_s"]["unit"] == "pairs/s"


def test_a_run_that_loaded_the_jax_package_prints_nothing(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gan_tpu", types.ModuleType("gan_tpu"))
    assert stub_run("pix2pix-512.b4.resident", False) is None
    assert "gan_tpu" in capsys.readouterr().err


def cli(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "pix2pix-512.b4.resident", "--seed", "3", "--seconds", "1",
                           "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={k: v for k, v in os.environ.items()
                                            if k != "GAN_TPU_PLATFORM"})


def test_without_a_card_the_cli_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = cli(REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "nothing is measured" in proc.stderr


def test_without_the_program_the_cli_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    proc = cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
