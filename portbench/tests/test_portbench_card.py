"""On the card: one short run of a cell through the CLI, correct, with its
result line's device numbers (skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("traced", ["0", "1"])
def test_a_short_run_on_the_card(card, traced):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "cyclegan-256.b4.resident", "--seed", "2147483911", "--seconds", "2",
                           "--trace", traced], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    if traced == "1":
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert {"step_mfu_pct", "device_idle_pct", "k1_roofline"} <= set(out["metrics"])
    else:
        assert out["metrics"]["train_pairs_per_s"]["value"] > 0
