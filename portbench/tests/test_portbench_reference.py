"""The plain reference (portbench/reference) against the port's eager step
on the CPU at 32x32, both in float32 from the same seeded weights, rows and
draws: the losses, every gradient, and Adam's update; and through the
harness, the port's first three epoch steps (its cached epoch runner)
against the reference's."""

import pytest
import torch

from portbench import cells, checks
from portbench.reference import cyclegan, nets, pix2pix, steps
from portbench_cases import tiny

CPU = torch.device("cpu")
MODELS = ("pix2pix-512.b4.resident", "cyclegan-256.b4.resident")


def both(name, seed):
    cell = tiny(name, dtype="fp32")
    c = cell["config"]
    trainer = cells.make_trainer(cell, seed, CPU)
    built = cells.model(c).build(c)
    weights = cells.make_weights(c, seed, CPU)
    for net, module in built.items():
        module.load_state_dict(weights[net])
    return cell, c, trainer, built


def reference_grads(c, built, objectives):
    out, groups = {}, cells.model(c).groups
    for i, (group, objective) in enumerate(zip(groups, objectives)):
        params = [p for net in group for p in built[net].parameters()]
        flat = torch.autograd.grad(objective, params, retain_graph=i < len(groups) - 1)
        for net in group:
            n = len(list(built[net].parameters()))
            out[net], flat = flat[:n], flat[n:]
    return out


def pass_masks(c, bx, by, masks):
    """The program's per-pass keep-masks from the reference's per-image ones."""
    return [[torch.cat([masks[o][site] for o in outputs]) for site in range(len(masks[outputs[0]]))]
            for _net, _inputs, outputs in cyclegan.passes(c, bx, by)]


@pytest.mark.parametrize("name", MODELS)
def test_the_reference_step_is_the_ports(name):
    seed = 11
    cell, c, trainer, built = both(name, seed)
    data = cells.resident_rows(cell, seed, CPU)
    draw = steps.Step(c, built, seed, 0, CPU)
    if c["model"] == "pix2pix":
        x, y, masks = pix2pix.draws(draw, data["train_x"][:4])
        objectives, want = pix2pix.objectives(c, built, x, y, masks, nets.identity)
        grads, losses = trainer.gradients(x, y, masks=[masks["fake"]])
    else:
        x, y, masks = cyclegan.draws(draw, data["train_x"][:4], data["train_y"][:4])
        objectives, want = cyclegan.objectives(c, built, x, y, masks, nets.identity)
        grads, losses = trainer.gradients(x, y, masks=pass_masks(c, 4, 4, masks))
    torch.testing.assert_close(losses, want.detach(), rtol=1e-5, atol=1e-6)
    ref = reference_grads(c, built, objectives)
    for net, module in built.items():
        names = [n for n, _ in module.named_parameters()]
        assert names == [n for n, _ in trainer.nets[net].named_parameters()]
        for n, got, exp in zip(names, grads[net], ref[net]):
            torch.testing.assert_close(got, exp, rtol=1e-3, atol=1e-7, msg=f"{net}.{n}")
    trainer.apply_gradients(grads)
    for net, module in built.items():   # the reference's Adam on the port's gradients
        steps.Adam(module.parameters(), c).step(grads[net])
        for (n, got), exp in zip(trainer.nets[net].named_parameters(), module.parameters()):
            torch.testing.assert_close(got.detach(), exp.detach(), rtol=1e-5, atol=1e-6,
                                       msg=f"{net}.{n}")


@pytest.mark.parametrize("name", MODELS + ("pix2pix-512.b4.files",))
def test_the_epoch_runners_first_steps_are_the_references(name, pool):
    """The port's epoch 0 through ``run_epoch`` (the window's call), its state
    read by the checks' hook, against the reference's three steps: at
    rounding in float32."""
    seed = 2**31 + 77
    cell = tiny(name, dtype="fp32")
    inputs = cells.program_inputs(cell, seed, CPU)
    trainer = cells.make_trainer(cell, seed, CPU)
    c = cell["config"]
    with checks.Snapshots(trainer, cells.model(c).trained(c)) as snap:
        first = cells.run_epoch(trainer, inputs, 0, True)
    assert trainer._step_draws.__func__ is type(trainer)._step_draws   # the hook is gone
    got = snap.readings(first, checks.start_weights(cell, seed, CPU), cell["config"]["beta_1"])
    gaps = checks.gaps(got, checks.reference_readings(cell, seed, CPU))
    assert gaps["loss"][0] < 1e-4 and gaps["grad1"][0] < 1e-4 and gaps["change"][0] < 1e-2, gaps
