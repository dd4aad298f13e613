"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import os

import pytest

from portbench import spec

from .helpers import ROOT

BENCH = spec.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in named:
        assert spec.NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(spec.NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in named if "why" in w] + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))


def test_entry_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for kind, want in keys.items():
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == want, e["name"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    c = spec.Cell(BENCH, cell)
    assert c.chips in (1, 4)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["name"] == c.workload["traffic"]
    assert callable(spec.entry(c.traffic["entry"]).run)
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_configs_files_and_reductions():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"]
            assert not key.endswith(("_dim", "_rank"))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        spec.config("no_such_config")
    with pytest.raises(ValueError):
        spec.traffic("../configs/readset_k21")
    with pytest.raises(KeyError):
        spec.Cell(BENCH, "no_such_cell")
