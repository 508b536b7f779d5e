"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""

import importlib
import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_its_day():
    """2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s a cell to
    compile and 1,200 s spare, for the 24 cells a benchmark may grow to."""
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_entry_keys():
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }
    for key, keys in allowed.items():
        for entry in BENCH[key]:
            assert set(entry) <= keys, (key, entry)
            assert NAME.match(entry["name"]), entry["name"]


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))


def test_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert (harness.PKG / "metrics" / f"{m['name']}.py").is_file()
        assert callable(importlib.import_module(f"portbench.metrics.{m['name']}").read)


def test_layers_named_alike():
    """Metrics of one layer give the same layer, letter for letter."""
    by_prefix = {}
    for m in BENCH["per_layer"]:
        by_prefix.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    w = cell.workload
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert conf["file"].startswith("portbench/") and conf["source"].startswith("https://")
    for key in conf["reduced"]:
        assert key in cell.config
    assert cell.config["reduced"] == conf["reduced"]
    assert (harness.PKG / "entries" / f"{cell.config['entry']}.py").is_file()
    assert int(cell.traffic["request_bytes"]) > 0 and int(cell.traffic["pool"]) >= 1
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names, (name, m["name"])


def test_config_files_are_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("key,value", [("clients", 2), ("loop", "open")])
def test_traffic_keys_the_harness_does_not_implement(key, value):
    from portbench import generate

    cell = harness.load_cell(CELLS[0])
    with pytest.raises(ValueError):
        generate.check(dict(cell.traffic, **{key: value}))


@pytest.mark.parametrize("change", [{"kind": "hash"}, {"stride": 2}, {"window": 8}])
def test_matchers_the_reference_does_not_hold(change):
    cell = harness.load_cell(CELLS[0])
    entry = importlib.import_module(f"portbench.entries.{cell.config['entry']}")
    with pytest.raises(ValueError):
        entry.check(dict(cell.config, matcher=dict(cell.config["matcher"], **change)))
