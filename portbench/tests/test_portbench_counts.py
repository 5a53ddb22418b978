"""portbench/counts.py against what the reference's own step does at 32x32:
its conv FLOPs forward and backward (torch's FlopCounterMode sees every
convolution and convolution_backward, with the gradients autograd asks
for), its instance norms and its stem convs (forward hooks)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import cells, counts
from portbench.reference import nets, steps
from portbench_cases import tiny

CELLS = ("pix2pix-512.b4.resident", "cyclegan-256.b4.resident")


def setup(name, seed=3):
    cell = tiny(name)
    c = cell["config"]
    built = cells.model(c).build(c)
    weights = cells.make_weights(c, seed, torch.device("cpu"))
    for net, module in built.items():
        module.load_state_dict(weights[net])
    data = cells.resident_rows(cell, seed, torch.device("cpu"))
    b = c["batch_size"]
    if c["model"] == "pix2pix":
        rows = lambda s: data["train_x"][s * b:(s + 1) * b]
    else:
        rows = lambda s: (data["train_x"][s * b:(s + 1) * b], data["train_y"][s * b:(s + 1) * b])
    return c, built, rows


@pytest.mark.parametrize("name", CELLS)
def test_train_step_flops_are_the_reference_steps(name):
    c, built, rows = setup(name)
    with FlopCounterMode(display=False) as flops:
        steps.run_steps(c, built, rows, seed=3, steps=1)
    b = c["batch_size"]
    assert flops.get_total_flops() == counts.step_flops(c, True, b, b)


@pytest.mark.parametrize("name", CELLS)
def test_val_step_flops_are_the_reference_forward(name):
    c, built, rows = setup(name)
    b = c["batch_size"]
    with torch.no_grad(), FlopCounterMode(display=False) as flops:
        cells.model(c).losses(c, built, rows(0), 3, 0, nets.identity)
    assert flops.get_total_flops() == counts.step_flops(c, False, b, b)


def test_cyclegan_tail_step_flops():
    """A zip tail of 1 X and 3 Y rows."""
    c, built, rows = setup("cyclegan-256.b4.resident")
    with FlopCounterMode(display=False) as flops:
        steps.run_steps(c, built, lambda s: (rows(0)[0][:1], rows(0)[1][:3]), seed=3, steps=1)
    assert flops.get_total_flops() == counts.step_flops(c, True, 1, 3)


@pytest.mark.parametrize("name", CELLS)
def test_stem_and_instance_norm_forward_ops(name):
    """Every stem (a Down without a norm) and every instance norm of a step,
    by elements, against counts' operations (bf16: 2 bytes an element)."""
    c, built, rows = setup(name)
    seen = {"stem_in": [], "norm": []}
    hooks = []
    for module in built.values():
        for m in module.modules():
            if isinstance(m, nets.Down) and m.norm is None:
                hooks.append(m.register_forward_hook(
                    lambda mod, inp, out: seen["stem_in"].append((inp[0].numel(), out.numel()))))
            if isinstance(m, nets.Norm) and m.kind == "instance":
                hooks.append(m.register_forward_hook(
                    lambda mod, inp, out: seen["norm"].append(inp[0].numel())))
    b = c["batch_size"]
    steps.run_steps(c, built, rows, seed=3, steps=1)
    for h in hooks:
        h.remove()
    stems = counts.stem_ops(c, True, b, b)
    assert len(stems) == len(seen["stem_in"])
    assert sum(s[0] for s in stems) == sum((i + o) * 2 + 64 * 16 * (i // (b * 32 * 32)) * 2
                                           for i, o in seen["stem_in"])
    assert sum(s[1] for s in stems) == sum(2.0 * o * 16 * (i // (b * 32 * 32))
                                           for i, o in seen["stem_in"])
    fwd = counts.norm_ops(c, True, b, b, backward=False)
    assert sum(op[1] for op in fwd) == counts.NORM_FWD_FLOPS * sum(seen["norm"])
    if c["model"] == "cyclegan":
        bwd = counts.norm_ops(c, True, b, b, backward=True)
        gen, disc = counts.norm_sites(c)
        # the generators' walk: 6 applications; D: fakes once, real and fake once more
        assert sum(op[1] for op in bwd) == counts.NORM_BWD_FLOPS * (
            6 * b * sum(h * h * ch for h, ch in gen) + 6 * b * sum(h * h * ch for h, ch in disc))
    else:
        assert fwd == [] and not seen["norm"]


def test_epoch_steps():
    p = tiny("pix2pix-512.b4.resident")["config"]
    assert counts.epoch_steps(p, 18) == [(4, 4, 0), (1, 2, 0)]
    c = tiny("cyclegan-256.b4.resident")["config"]
    assert counts.epoch_steps(c, 17, 19) == [(4, 4, 4), (1, 1, 3)]
    full = cells.load("cyclegan-256.b4.resident")["config"]
    assert counts.epoch_steps(full, 766, 818) == [(191, 4, 4), (1, 2, 4)]


def test_bound_is_the_larger_of_bytes_and_operations():
    assert counts.bound_s(3.35e12, 0, "bf16") == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12 * 2, "bf16") == pytest.approx(2.0)
