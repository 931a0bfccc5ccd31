"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, limits and per-layer readers are found by name, and the file
keeps the contract's shapes."""

import json
import re

import pytest

import drive
import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    loaded = harness.load_cell(cell)
    assert loaded["config"]["name"] == loaded["cell"]["config"]
    cls = drive.driver_class(loaded["config"], loaded["mix"])
    assert issubclass(cls, drive.Driver) and callable(cls.step)
    assert int(loaded["mix"]["starts"]) >= 1
    assert isinstance(loaded["limits"], dict)
    e2e = {m["name"] for m in loaded["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert loaded["per_layer"], "every cell reports a per-layer metric"
    for m in loaded["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)
        assert m["moves"] in e2e


def test_configs_are_used_and_own_their_files():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_metric_workloads_exist():
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in CELLS, (m["name"], w)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in layer for layer in layers)
