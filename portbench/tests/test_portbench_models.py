"""One file per model (``portbench/models/<model>.py``): the harness asks the
configuration's model file for everything that depends on the model, and
keeps no model's name.

(a) The counts of the benchmark's cells are the ones the harness read when
it still branched on the model, pinned value for value; (b) so are the
seeded weights, rows and the reference's three steps at 32x32, both
models; ``recorded_readings.json`` beside this file holds those readings,
taken from the harness before the per-model files existed. (c) A third
model, written by the test into a directory of its own, is found by name:
rectangular images, one frozen network, its own counts. (d) No model's name
is left in the harness's generic files.
"""

import glob
import hashlib
import json
import os
import re
import textwrap
import types

import pytest
import torch

from portbench import cells, checks, counts, models
from portbench.reference import steps
from portbench_cases import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
CPU = torch.device("cpu")
TINY_SEED = 2**31 + 19
CELLS = ("pix2pix-512.b4.resident", "pix2pix-512.b4.files", "cyclegan-256.b4.resident")


@pytest.fixture(scope="module")
def recorded():
    with open(os.path.join(HERE, "recorded_readings.json")) as f:
        return json.load(f)


def full_cell(name: str) -> dict:
    if name == "cyclegan-256.b8":
        return cells.load("cyclegan-256.b8.resident")
    return cells.load(name)


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def lists(ops) -> list:
    return [list(op) for op in ops]


# (a) the counts

@pytest.mark.parametrize("name", CELLS + ("cyclegan-256.b8",))
def test_the_counts_are_the_recorded_ones(name, recorded):
    want = recorded["counts"][name]
    cell = full_cell(name)
    c = cell["config"]
    n = cells.counts(cell)
    assert list(n) == want["counts"]
    assert {k: [list(s) for s in v] for k, v in want["epoch_steps"].items()} == {
        "train": lists(counts.epoch_steps(c, n[0], n[1])),
        "val": lists(counts.epoch_steps(c, n[2], n[3]))}
    for s in want["steps"]:
        args = (c, s["training"], s["bx"], s["by"])
        assert counts.step_flops(*args) == s["step_flops"]
        assert lists(counts.norm_ops(*args, False)) == s["norm_fwd"]
        assert lists(counts.norm_ops(*args, True)) == s["norm_bwd"]
        assert lists(counts.stem_ops(*args)) == s["stem"]
    assert sum(k * counts.step_flops(c, True, bx, by)
               for k, bx, by in counts.epoch_steps(c, n[0], n[1])) == want["epoch_flops"]
    assert {k: list(v) for k, v in cells.row_shapes(cell).items()} == {
        k: want["row_shapes"][k[:-2]] for k in cells.row_shapes(cell)}


@pytest.mark.parametrize("name, full, tail, flops, epoch_flops, k1_sites, stems", [
    ("pix2pix-512.b4.resident", (255, 4, 0), (1, 2, 0), 1.284197056512e12, 3.28112347938816e14,
     0, 3),
    ("pix2pix-512.b4.files", (255, 4, 0), (1, 2, 0), 1.284197056512e12, 3.28112347938816e14,
     0, 3),
    ("cyclegan-256.b4.resident", (191, 4, 4), (1, 2, 4), 1.204054130688e12,
     2.30877379559424e14, 17, 10),
    ("cyclegan-256.b8", (95, 8, 8), (1, 6, 8), 2.408108261376e12, 2.30877379559424e14, 17, 10),
])
def test_the_cells_step_and_epoch(name, full, tail, flops, epoch_flops, k1_sites, stems):
    cell = full_cell(name)
    c = cell["config"]
    n = cells.counts(cell)
    plan = counts.epoch_steps(c, n[0], n[1])
    assert plan == [full, tail]
    _k, bx, by = full
    assert counts.step_flops(c, True, bx, by) == flops
    assert sum(k * counts.step_flops(c, True, x, y) for k, x, y in plan) == epoch_flops
    assert len(counts.norm_ops(c, True, bx, by, False)) == k1_sites
    assert len(counts.stem_ops(c, True, bx, by)) == stems


@pytest.mark.parametrize("name", CELLS)
def test_the_program_config_is_the_recorded_one(name, recorded):
    import dataclasses
    got = dataclasses.asdict(cells.program_config(cells.load(name), TINY_SEED))
    assert got == recorded["program_config"][name]


def test_a_configuration_the_program_does_not_run_is_refused():
    cell = cells.load("cyclegan-256.b4.resident")
    cell["config"]["generator"] = dict(cell["config"]["generator"], norm="batch")
    with pytest.raises(ValueError, match="not what the program runs"):
        cells.program_config(cell, 1)


# (b) weights, rows and the reference's steps at 32x32

@pytest.mark.parametrize("name", CELLS)
def test_weights_rows_and_reference_steps_are_the_recorded_ones(name, recorded, pool):
    want = recorded["tiny"][name]
    cell = tiny(name)
    c = cell["config"]
    w = cells.make_weights(c, TINY_SEED, CPU)
    assert {f"{net}.{k}": sha(t) for net, ps in w.items() for k, t in ps.items()} == \
        want["weights"]
    if cell["storage"] == "resident":
        assert {k: sha(t) for k, t in cells.resident_rows(cell, TINY_SEED, CPU).items()} == \
            want["rows"]
    else:
        assert [[os.path.basename(p) for p in part]
                for part in cells.file_lists(cell, TINY_SEED)] == want["files"]
    ref = checks.reference_readings(cell, TINY_SEED, CPU)
    assert ref["losses"].tolist() == want["reference"]["losses"]
    assert ref["grad1"] == want["reference"]["grad1"]
    assert ref["change"] == want["reference"]["change"]
    assert {k: sha(t) for k, t in ref["grad1_t"].items()} == want["reference"]["grad1_t"]


# (c) a third model, as new files only

TOY_MODEL = '''
"""A toy model: a 3x3 conv generator on rectangular images, trained on L1
plus the distance of a frozen 3x3 conv's features."""

import torch
import torch.nn.functional as F
from torch import nn

from portbench import cells
from portbench.reference.steps import Step, device_of

groups = (("gen",),)


class Conv(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = nn.Parameter(torch.empty(c, c, 3, 3))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x, q):
        return F.conv2d(q(x), q(self.conv), padding=1) + self.bias[:, None, None]


def build(config):
    return {"gen": Conv(config["channels"]), "feat": Conv(config["channels"])}


def trained(config):
    return ["gen"]


def losses(config, nets, rows, seed, step, q):
    noise = torch.rand((), generator=Step(config, nets, seed, step, device_of(nets)).gen(0))
    x = rows[:, 0].permute(0, 3, 1, 2).float() / 127.5 - 1.0 + noise
    y = rows[:, 1].permute(0, 3, 1, 2).float() / 127.5 - 1.0
    fake = nets["gen"](x, q)
    feat = (nets["feat"](fake, q) - nets["feat"](y, q)).abs().mean()
    total = (fake - y).abs().mean() + feat
    return (total,), torch.stack([total, feat])


def program_config(cell, seed):
    raise NotImplementedError("no program runs the toy")


make_trainer = program_inputs = program_config


def counts(config):
    return config["train_n"], 0, config["val_n"], 0


def row_shapes(config):
    shape = (2, config["height"], config["width"], config["channels"])
    return {"train_x": shape, "val_x": shape}


def epoch_pairs(config, n):
    return n[0]


def reference_rows(cell, seed, device):
    data, b = cells.resident_rows(cell, seed, device), cell["config"]["batch_size"]
    return lambda s: data["train_x"][s * b:(s + 1) * b]


def _macs(config):
    return config["height"] * config["width"] * config["channels"] ** 2 * 9


def step_flops(config, training, bx, by=0):
    # gen: forward, wgrad (x needs no dgrad); feat on fake: forward, dgrad;
    # feat on y: forward
    return 2.0 * bx * _macs(config) * ((5 if training else 3))


def epoch_steps(config, n_x, n_y=0):
    full, tail = divmod(n_x, config["batch_size"])
    return [(full, config["batch_size"], 0)] + ([(1, tail, 0)] if tail else [])


def norm_ops(config, training, bx, by, backward):
    return []


def stem_ops(config, training, bx, by=0):
    return [(bx * config["height"] * config["width"] * 4.0, 2.0 * bx * _macs(config))]
'''

TOY_CONFIG = {"name": "toy-rect", "model": "toy", "height": 16, "width": 24, "channels": 2,
              "batch_size": 2, "train_n": 9, "val_n": 3, "dtype": "fp32",
              "learning_rate": 2e-4, "beta_1": 0.5, "beta_2": 0.999, "adam_epsilon": 1e-7}
TOY_CELL = {"name": "toy-rect.b2.resident", "config": "toy-rect", "traffic": "b2.resident",
            "chips": 1, "storage": "resident", "why": "the harness's test of a third model",
            "limits": {"loss": 0.01, "grad1": 0.01, "grad1_diff": 0.1, "change": 0.1}}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's model, configuration and cell, in a directory of their own."""
    for kind in ("models", "configs", "workloads"):
        (tmp_path / kind).mkdir()
    (tmp_path / "models" / "toy.py").write_text(textwrap.dedent(TOY_MODEL))
    (tmp_path / "configs" / "toy-rect.json").write_text(json.dumps(TOY_CONFIG))
    (tmp_path / "workloads" / "toy-rect.b2.resident.json").write_text(json.dumps(TOY_CELL))
    monkeypatch.setattr(models, "ROOT", str(tmp_path / "models"))
    monkeypatch.setattr(cells, "ROOT", str(tmp_path))
    return cells.load("toy-rect.b2.resident")


def loaded(cell, seed):
    c = cell["config"]
    built = cells.model(c).build(c)
    weights = cells.make_weights(c, seed, CPU)
    for net, module in built.items():
        module.load_state_dict(weights[net])
    return c, built, weights


def test_a_third_model_is_found_by_name(toy):
    c = toy["config"]
    assert cells.model(c).name == "toy" and cells.model(c).trained(c) == ["gen"]
    assert cells.counts(toy) == (9, 0, 3, 0)
    assert counts.epoch_steps(c, 9) == [(4, 2, 0), (1, 1, 0)]
    macs = 16 * 24 * 2 * 2 * 9
    assert counts.step_flops(c, True, 2) == 2.0 * 2 * macs * 5
    assert counts.step_flops(c, False, 2) == 2.0 * 2 * macs * 3
    assert counts.norm_ops(c, True, 2, 0, False) == [] == counts.norm_ops(c, True, 2, 0, True)
    assert counts.stem_ops(c, True, 2) == [(2 * 16 * 24 * 4.0, 2.0 * 2 * macs)]
    rows = cells.resident_rows(toy, 5, CPU)
    assert rows["train_x"].shape == (9, 2, 16, 24, 2) and rows["val_x"].shape == (3, 2, 16, 24, 2)
    weights = cells.make_weights(c, 5, CPU)
    assert set(weights) == {"gen", "feat"}
    assert weights["feat"]["conv"].std() > 0 and not weights["feat"]["bias"].any()


def test_a_frozen_network_takes_no_adam_and_no_change_reading(toy):
    c, built, weights = loaded(toy, 7)
    out = steps.run_steps(c, built, cells.model(c).reference_rows(toy, 7, CPU), 7, 3)
    assert set(out["grad1"]) == set(out["change"]) == {"gen.conv", "gen.bias"}
    assert out["losses"].shape == (3, 2) and all(v > 0 for v in out["change"].values())
    for n, p in built["feat"].named_parameters():
        assert torch.equal(p.detach(), weights["feat"][n])
    # the harness's own reading of the reference goes the same way
    ref = checks.reference_readings(toy, 7, CPU)
    assert ref["losses"].tolist() == out["losses"].tolist()


def test_the_toys_counts_are_its_reference_step(toy):
    """Its own FLOP count holds for its reference step: the frozen network
    takes a dgrad on the fake and no wgrad."""
    from torch.utils.flop_counter import FlopCounterMode
    c, built, _weights = loaded(toy, 3)
    with FlopCounterMode(display=False) as flops:
        steps.run_steps(c, built, cells.model(c).reference_rows(toy, 3, CPU), 3, 1)
    assert flops.get_total_flops() == counts.step_flops(c, True, 2)


def test_a_frozen_network_gets_the_control(toy):
    c, built, _weights = loaded(toy, 3)
    seen = []

    def q(t):
        seen.append(t)
        return steps.fp8(t)

    cells.model(c).losses(c, built, cells.model(c).reference_rows(toy, 3, CPU)(0), 3, 0, q)
    assert any(t is built["feat"].conv for t in seen) and any(t is built["gen"].conv for t in seen)


def test_snapshots_read_the_trained_networks_only(toy):
    c, built, _weights = loaded(toy, 3)
    opt = torch.optim.Adam(built["gen"].parameters())
    trainer = types.SimpleNamespace(nets=built, opts={"gen": opt})
    snap = checks.Snapshots(trainer, cells.model(c).trained(c))
    assert [leaf for leaf, _p, _s in snap._leaves()] == ["gen.conv", "gen.bias"]


def test_an_unknown_model_is_a_clear_error():
    with pytest.raises(ValueError, match="unknown model 'nosuch'.*cyclegan.*pix2pix"):
        models.get("nosuch")
    with pytest.raises(ValueError, match="not a valid model name"):
        models.get("../cells")


# (d) no model's name in the generic files

GENERIC = ("cells.py", "counts.py", "harness.py", "checks.py", "reference/steps.py", "trace.py",
           "spans.py", "faults.py", "calibrate.py", "corpus.py", "run.py", "metrics/*.py")


@pytest.mark.parametrize("pattern", GENERIC)
def test_the_harness_names_no_model(pattern):
    paths = glob.glob(os.path.join(BENCH, pattern))
    assert paths
    for path in paths:
        with open(path) as f:
            found = re.findall(r"pix2pix|cyclegan", f.read(), re.IGNORECASE)
        assert not found, (path, found)
