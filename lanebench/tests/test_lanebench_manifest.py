"""BENCHMARK.json parses, keeps to its contract's form, and every cell finds
its files by name."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_units_and_lines(manifest):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[key]:
            assert NAME.match(e["name"]), e["name"]
            names.append((key, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200
                    assert "\n" not in e[k] and "\t" not in e[k]
    assert len(set(n for _, n in names)) == len(names)
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16


def test_metric_keys_and_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cells:
        mine = [m for m in manifest["end_to_end"]
                if w in m.get("workloads", [w])]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(w in m["workloads"] for m in manifest["per_layer"])


def test_check_budget_fits(manifest):
    """A full check with the whole 24 cells fits its 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_every_cell_finds_its_files(manifest):
    from lanebench import core
    for w in manifest["workloads"]:
        cell = core.Cell(w["name"])
        assert cell.config["batch_size"] == cell.traffic["batch"]
        assert os.path.isfile(os.path.join(
            ROOT, "lanebench", "loops", cell.traffic["loop"] + ".py"))
        assert callable(core.loop(cell).run)
        for m in cell.per_layer:
            assert callable(core.reader(m["name"]))
        assert set(cell.limits) >= (
            {"input_gap", "head_gap"} if cell.traffic["loop"] == "serve"
            else {"head1_gap", "grad_gap", "change_gap"})
    for c in manifest["configs"]:
        assert c["file"].startswith(manifest["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["_reduced"] == c["reduced"]
