"""BENCHMARK.json against the benchmark's contract: the keys, the characters
of every name and unit, and that each configuration, cell and per-layer
metric has its file under portbench/ for the harness to find by name."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head).*|.*(_dim|_rank)$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.match(key), key
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(("cell", w["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for _kind, name in names:
        assert NAME.match(name), name
    assert len(set(names)) == len(names)
    assert all(line(word) for word in bench["command"])


def test_end_to_end_and_per_layer(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_piece_has_its_file(bench):
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(REPO, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert set(config["published"]) >= set(c["reduced"])
    for w in bench["workloads"]:
        with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as f:
            cell = json.load(f)
        assert {k: cell[k] for k in ("name", "config", "traffic", "chips")} == \
            {k: w[k] for k in ("name", "config", "traffic", "chips")}
        assert set(cell["limits"]) == {"loss", "grad1", "grad1_diff", "change"}
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        mine = lambda m: w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in bench["end_to_end"] if mine(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(mine(m) for m in bench["per_layer"])


def test_at_most_a_quarter_of_the_cells_take_four_chips(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
