"""The harness on the card: both cells at a reduced size, traced, the
control, and the command without the program. Marked ``cuda``; each test
skips without a CUDA device (decided inside the test).

    python3 -m pytest portbench/tests -q
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run, spec

from .helpers import ROOT

pytestmark = pytest.mark.cuda

#: a sixteenth of each cell: the same shapes, seconds to run
SMALL = {"readset_k21_clean": {"total_bases": 32_000_000, "genome_bases": 1_000_000},
         "assembly_k31_hist": {"total_bases": 8_000_000}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _small(name):
    cell = spec.Cell(spec.benchmark(ROOT), name)
    cell.config = dict(cell.config, **SMALL[name])
    return cell


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("traced", [False, True])
def test_a_cell_on_the_card(name, traced):
    dev = _card()
    cell = _small(name)
    out = run.run_cell(cell, 2**31 + 101, 2.0, traced, dev)
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(out["metrics"]) == want
    if traced:
        assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
        for m in ("codec_roofline_pct", "rle_roofline_pct"):
            assert 0 < out["metrics"][m]["value"] < 100
        assert out["breakdown"]["device_ops"]
    # the route is recorded, not checked: one codec or the other ran
    assert out["route"]["encode_windows"] + out["route"]["encode_dense"] > 0


def test_the_control_fails_on_the_card():
    from portbench import control

    dev = _card()
    for name in sorted(SMALL):
        got = control.readings(_small(name), 2**31 + 103, dev)
        assert all(v == 0 for v in got["program"].values())
        assert got["control"]["entries_off"] > 0


def test_without_the_program_the_command_fails(tmp_path):
    _card()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "assembly_k31_hist", "--seed",
         str(2**31 + 107), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") and json.loads(line) for line in
                   proc.stdout.splitlines())
