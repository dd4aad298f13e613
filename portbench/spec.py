"""Finds a cell's configuration, traffic mix, entry and metric readers by
the names ``BENCHMARK.json`` gives them. Nothing here imports the port."""

from __future__ import annotations

import importlib
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
#: names and units as the benchmark's contract allows them
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ".") -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _named(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def config(name: str) -> dict:
    return _load_json(_named("configs", name, ".json"))


def traffic(name: str) -> dict:
    return _load_json(_named("traffic", name, ".json"))


def entry(name: str):
    """The entry module: ``run(path, cfg) -> PackedCounts`` and, where the
    configuration asks for output, ``output(result, cfg) -> bytes``."""
    _named("entries", name, ".py")
    return importlib.import_module(f"portbench.entries.{name}")


def metric_reader(name: str):
    """The per-layer metric's reader: ``read(window) -> float | None``."""
    _named("metrics", name, ".py")
    return importlib.import_module(f"portbench.metrics.{name}").read


class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix and
    the metrics ``BENCHMARK.json`` asks of it."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        self.config = config(self.workload["config"])
        self.traffic = traffic(self.workload["traffic"])
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
