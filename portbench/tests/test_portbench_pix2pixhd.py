"""pix2pixHD (``models/pix2pixhd.py``, ``reference/pix2pixhd.py``, the
``pix2pixhd-512p.b1.resident`` cell, ``metrics/pad_device_pct.py``) on the
CPU, in a file of its own so that the other models' tests and
``portbench_cases.tiny`` stay as they were: a tiny cell through the
harness's run reads ``correct``; each planted fault and the float8 control
read it false; the counts at the tiny size are the FLOPs that torch's flop
counter reads off the reference's step, and at the cell's size the
published networks' arithmetic; the rows are what the cell says; the
benchmark's copy of the reference equals the repository's
(``tests/pix2pixhd_reference.py``) on a seeded step; ``pad_device_pct``
reads a synthetic stretch."""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from portbench import cells, checks, counts, faults, harness, trace
from portbench.reference import pix2pixhd, steps

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CPU = torch.device("cpu")
CELL = "pix2pixhd-512p.b1.resident"
SEED = 2**31 + 23


def tiny(**config) -> dict:
    """The cell at 64x32 with ngf 8, 2 downsamplings and 2 blocks, at batch
    2 (so that half a batch is a fault), 9 train and 3 val rows: 4 full
    steps and a 1-row tail."""
    cell = cells.load(CELL)
    cell["config"].update(height=32, width=64, ngf=8, n_downsample_global=2, n_blocks_global=2,
                          batch_size=2, train_pairs=9, val_pairs=3, **config)
    return cell


def run(plant=None, seed=SEED):
    return harness.run(tiny(dtype="fp32"), seed, 0.1, False, CPU, time.perf_counter(),
                       plant=plant)


def test_a_sound_tiny_run_is_correct():
    out = run()
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 7 and set(out["metrics"]) == {"train_pairs_per_s",
                                                              "peak_mem_gib", "setup_s"}
    assert out["checks"]["loss"]["value"] < 1e-3 and out["checks"]["change"]["value"] < 1e-2


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_step_is_not_correct(fault):
    out = run(faults.FAULTS[fault])
    assert out["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def _vgg_dropped(trainer):
    trainer.vgg = None


def _vgg_detached(trainer):
    """The VGG term's forward as it was, its gradient into the fake gone."""
    forward = trainer.vgg.forward
    trainer.vgg.forward = lambda x, **kw: forward(x.detach(), **kw)


@pytest.mark.parametrize("plant", [_vgg_dropped, _vgg_detached], ids=["dropped", "detached"])
def test_a_step_with_a_broken_vgg_term_is_not_correct(plant):
    """The VGG trunk, loaded at He scale, weighs in the compared numbers: a
    program that drops its term, or only its backward, reads ``correct``
    false, and its first gradient's difference is far above a sound run's
    (3e-4 at this size in fp32)."""
    out = run(plant)
    assert out["correct"] is False
    assert out["checks"]["grad1_diff"]["value"] > 0.1


def test_both_sides_load_the_vgg_at_he_scale():
    """The program's trunk and the reference's take the same seeded kernels,
    each N(0, 2 / fan_in); the seeded weights themselves stay as drawn."""
    cell = tiny(dtype="fp32")
    c = cell["config"]
    weights = cells.make_weights(c, 5, CPU)
    drawn = weights["vgg"]["features.0.weight"].clone()
    ref = cells.model(c).build(c)["vgg"]
    ref.load_state_dict(weights["vgg"])
    program = cells.make_trainer(cell, 5, CPU).vgg.state_dict()
    assert torch.equal(weights["vgg"]["features.0.weight"], drawn)
    for k, v in ref.state_dict().items():
        assert torch.equal(program[k], v), k
        if k.endswith("weight"):
            assert v.std().item() == pytest.approx((2.0 / v[0].numel()) ** 0.5, rel=0.1), k
        else:
            assert not v.any(), k


def test_the_control_fails_the_limits():
    cell = tiny()
    for seed in (1, 2, 3):
        ref = checks.reference_readings(cell, seed, CPU)
        control = checks.reference_readings(cell, seed, CPU, q=steps.fp8)
        assert not checks.verdict(checks.gaps(control, ref), cell["limits"]), seed


def test_the_counts_are_the_reference_steps_conv_flops():
    """The FLOPs of the reference's first step, counted by torch, are
    ``step_flops``: G's forward, wgrad and dgrad but the stem's; the VGG's
    forward on both images and its dgrad on the fake; each discriminator
    three times (8D − 2 stems)."""
    from torch.utils.flop_counter import FlopCounterMode
    cell = tiny(dtype="fp32")
    c = cell["config"]
    built = cells.model(c).build(c)
    weights = cells.make_weights(c, 3, CPU)
    for net, module in built.items():
        module.load_state_dict(weights[net])
    rows = cells.model(c).reference_rows(cell, 3, CPU)
    with FlopCounterMode(display=False) as flops:
        steps.run_steps(c, built, rows, 3, 1)
    assert flops.get_total_flops() == counts.step_flops(c, True, 2)
    with FlopCounterMode(display=False) as flops, torch.no_grad():
        pix2pixhd.losses(c, built, rows(0), 3, 0, pix2pixhd.identity)
    assert flops.get_total_flops() == counts.step_flops(c, False, 2)


def test_the_cells_counts():
    cell = cells.load(CELL)
    c = cell["config"]
    assert cells.counts(cell) == (256, 0, 32, 0)
    assert counts.epoch_steps(c, 256) == [(256, 1, 0)] and counts.epoch_steps(c, 32) == [(32, 1, 0)]
    assert counts.step_flops(c, True, 1) == 4.572816515072e12
    assert counts.stem_ops(c, True, 1) == []
    gen, disc = cells.model(c).norm_sites(c)
    assert len(gen) == 27 and disc == [(129, 257, 128), (65, 129, 256), (66, 130, 512),
                                       (65, 129, 128), (33, 65, 256), (34, 66, 512)]
    fwd, bwd = (counts.norm_ops(c, True, 1, 0, b) for b in (False, True))
    assert len(fwd) == len(bwd) == 33 and counts.norm_ops(c, False, 1, 0, True) == []
    assert fwd[0] == (2 * 512 * 1024 * 64 * 2 + 2 * 64 * 4, 7 * 512 * 1024 * 64)
    assert bwd[-1] == (3 * 3 * 34 * 66 * 512 * 2 + 3 * 512 * 4, 11 * 3 * 34 * 66 * 512)
    assert cells.model(c).trained(c) == ["gen", "disc_0", "disc_1"]
    specs = cells.param_specs(c)
    assert {n: sum(int(np.prod(s)) for _, s in ps) for n, ps in specs.items()} == {
        "gen": 182_546_755, "disc_0": 2_801_601, "disc_1": 2_801_601, "vgg": 12_944_960}


def test_the_rows_and_weights_are_what_the_cell_says():
    """At the cell's 1024x512: label ids in [0, 35) over 32-px cells,
    instance ids over 64-px cells, so that about 6% of pixels are edges."""
    cell = cells.load(CELL)
    cell["config"].update(train_pairs=3, val_pairs=1)
    rows = cells.program_inputs(cell, 5, CPU)
    assert rows["train_x"].shape == (3, 512, 1024, 6) and rows["val_x"].shape == (1, 512, 1024, 6)
    x = rows["train_x"]
    assert int(x[..., 0].max()) == 34 and torch.equal(x, cells.program_inputs(cell, 5, CPU)["train_x"])
    from gan_tpu_torch.data.labels import edges
    ids = x[..., 1].long() * 256 + x[..., 2].long()
    share = float(edges(ids).float().mean())
    assert 0.055 < share < 0.07, share   # 1 − (62/64)²
    label = x[0, ..., 0]
    assert torch.equal(label[:32, :32], label[0, 0].expand(32, 32))
    assert not torch.equal(label[:32, 32:64], label[0, 0].expand(32, 32))
    model = cells.model(cell["config"])
    perm = model.order(5, 0, 3)
    assert torch.equal(model.reference_rows(cell, 5, CPU)(1), x[int(perm[1])][None])
    w = cells.make_weights(tiny()["config"], 5, CPU)
    assert set(w) == {"gen", "disc_0", "disc_1", "vgg"}
    assert not w["gen"]["stem.bias"].any() and w["vgg"]["features.0.weight"].std() > 0.01


def _repo_reference():
    spec = importlib.util.spec_from_file_location(
        "repo_pix2pixhd_reference", os.path.join(REPO, "tests", "pix2pixhd_reference.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_benchmarks_copy_equals_the_repositorys_reference():
    """One seeded step of both copies from the same weights and rows: the
    losses and every gradient bit for bit."""
    repo = _repo_reference()
    cell = tiny(dtype="fp32")
    c = cell["config"]
    weights = cells.make_weights(c, 7, CPU)
    pair = []
    for module in (pix2pixhd, repo):
        nets = module.build(c)
        for net, m in nets.items():
            m.load_state_dict(weights[net])
        pair.append(nets)
    rows = cells.model(c).reference_rows(cell, 7, CPU)(0)
    flip = torch.rand(2, generator=steps.Step(c, pair[0], 7, 0, CPU).gen(pix2pixhd.FLIP)) > 0.5
    got_obj, got = pix2pixhd.losses(c, pair[0], rows, 7, 0, pix2pixhd.identity)
    want_obj, want = repo.objectives(c, pair[1], *repo.encode_input(rows, flip, c))
    assert torch.equal(got, want)
    for nets, objectives in ((pair[0], got_obj), (pair[1], want_obj)):
        nets["grads"] = torch.autograd.grad(objectives[0], list(nets["gen"].parameters()),
                                            retain_graph=True)
        nets["grads"] += torch.autograd.grad(objectives[1], [p for i in (0, 1) for p in
                                                             nets[f"disc_{i}"].parameters()])
    assert all(torch.equal(a, b) for a, b in zip(pair[0]["grads"], pair[1]["grads"]))


def test_pad_device_pct_reads_a_synthetic_stretch():
    read = trace.load_reader("pad_device_pct")
    stretch = trace.Stretch(
        device=[("void at::native::(anonymous namespace)::reflection_pad2d_out_kernel<float>", 0.0,
                 30.0),
                ("void at::native::(anonymous namespace)::reflection_pad2d_backward_out_kernel"
                 "<c10::BFloat16>", 40.0, 10.0),
                ("sm90_xmma_fprop_implicit_gemm_bf16", 60.0, 160.0)],
        start=0.0, end=300.0, config={"dtype": "bf16"}, steps=[], window={})
    assert read(stretch) == pytest.approx(100.0 * 40.0 / 200.0)
    stretch.device = stretch.device[2:]
    assert read(stretch) is None
    stretch.device = []
    assert read(stretch) is None
