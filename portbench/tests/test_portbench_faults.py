"""The comparison that decides ``correct`` fails what it should: a run of a
tiny cell whose timed path is broken underneath (the look for a card skipped,
the rest of the run driven as the CLI drives it) comes out not correct, for
each fault a one-chip training cell can have: a step that leaves the state
as it was, and half of each batch left out with the mean taken over the
rest. The program runs in float32 here, so that a sound run reads at
rounding and passes, and the cell's own limits are held. And the control,
the reference with every conv operand in float8 e4m3, fails the cells'
limits at a size a test run holds (the chip reads it at the cells' sizes:
``calibrate.py --control``)."""

import time

import pytest
import torch

from portbench import checks, faults, harness
from portbench.reference import steps
from portbench_cases import tiny

CPU = torch.device("cpu")
CELLS = ("pix2pix-512.b4.resident", "cyclegan-256.b4.resident")


def run(name, plant=None):
    return harness.run(tiny(name, dtype="fp32"), 2**31 + 91, 0.1, False, CPU,
                       time.perf_counter(), plant=plant)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert run(name)["correct"] is True


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault):
    out = run(name, faults.FAULTS[fault])
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    cell = tiny(name)
    failed = 0
    for seed in (1, 2, 3):
        ref = checks.reference_readings(cell, seed, CPU)
        control = checks.reference_readings(cell, seed, CPU, q=steps.fp8)
        failed += not checks.verdict(checks.gaps(control, ref), cell["limits"])
    assert failed == 3


def test_half_batch_keeps_each_applications_masks_across_the_passes_forms():
    """At a batch past the batched passes' limit, half of it runs the batched
    form: each application's masks are still the first rows of its own."""
    from portbench import cells
    cell = tiny("cyclegan-256.b4.resident", dtype="fp32", batch_size=8)
    trainer = cells.make_trainer(cell, 5, CPU)
    trainer.BATCHED_PASS_MAX = 4
    seen = {}
    trainer.train_step = lambda x, y, generators=None, masks=None, bn_group=None: \
        seen.update(x=x, y=y, masks=masks)
    faults.half_batch(trainer)
    full, halved = trainer.passes(8, 8), trainer.passes(4, 4)
    assert len(full) == 6 and len(halved) == 3
    masks = [[torch.arange(8 * len(outputs)) + 1000 * k + 100 * site for site in range(2)]
             for k, (_net, _inputs, outputs) in enumerate(full)]
    want = {name: [m[j * 8:j * 8 + 4] for m in drawn]
            for drawn, (_net, _inputs, outputs) in zip(masks, full)
            for j, name in enumerate(outputs)}
    x, y = torch.zeros(8, 1), torch.ones(8, 1)
    trainer.train_step(x, y, masks=masks)
    assert seen["x"].shape[0] == 4 and seen["y"].shape[0] == 4
    assert len(seen["masks"]) == len(halved)
    for drawn, (_net, _inputs, outputs) in zip(seen["masks"], halved):
        for site in range(2):
            assert torch.equal(drawn[site], torch.cat([want[name][site] for name in outputs]))
