"""The harness on the CPU: no card means no result; a run that loads JAX
or the JAX package is caught; the comparison sees each fault planted
under the timed path; and the reference stays apart from the port."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench import run

from .helpers import CPU, ROOT, tiny_cell

SECONDS = 0.3


def _python(code, cwd=ROOT, **env):
    full = dict(os.environ, **env)
    if cwd != ROOT:
        full.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "readset_k21_clean",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA device" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("krust_tpu_torch_extra", "krust_tpux"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "krust_tpu.ops", types.ModuleType("krust_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "krust_tpu.ops"]


def test_a_cpu_pipeline_loads_neither_jax_nor_krust_tpu():
    code = (
        "import json, sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests.helpers import tiny_cell\n"
        "out = run.run_cell(tiny_cell('assembly_k31_hist'), 2**31 + 17, 0.2, True,"
        " torch.device('cpu'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'krust_tpu')]\n"
        "print(json.dumps({'bad': bad, 'correct': out['correct'],"
        " 'port': 'krust_tpu_torch' in sys.modules, 'seen': out['forbidden_modules']}))\n")
    proc = _python(code, KRUST_PLATFORM="cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True, "port": True, "seen": []}


YARDSTICK = ("reference", "compare", "gen", "roofline", "trace", "spec")


def test_the_reference_imports_nothing_of_the_port():
    for name in YARDSTICK:
        with open(os.path.join(ROOT, "portbench", name + ".py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(m.split(".")[0] in ("krust_tpu_torch", "krust_tpu", "jax")
                           for m in mods), (name, mods)
    code = ("import sys\n" + "".join(f"import portbench.{n}\n" for n in YARDSTICK)
            + "import portbench.run, portbench.control\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('krust_tpu_torch', 'krust_tpu', 'jax')))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch\nfrom portbench import run\nfrom portbench.tests.helpers import"
            " tiny_cell\nrun.run_cell(tiny_cell('readset_k21_clean'), 5, 0.2, False,"
            " torch.device('cpu'))\nprint('{}')\n")
    proc = _python(code, cwd=str(tmp_path))
    assert proc.returncode != 0 and "{}" not in proc.stdout
    assert "krust_tpu_torch" in proc.stderr


@pytest.fixture
def cpu_port(monkeypatch):
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    from krust_tpu_torch.ops import table

    return table


@pytest.mark.parametrize("cell", ["readset_k21_clean", "assembly_k31_hist"])
def test_a_sound_run_is_correct(cpu_port, cell):
    out = run.run_cell(tiny_cell(cell), 2**31 + 23, SECONDS, False, CPU)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"mbases_per_s", "peak_device_gib", "peak_host_gib",
                                   "setup_s"}
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())


def _state_unchanged(monkeypatch, table):
    monkeypatch.setattr(table.EpochTable, "add", lambda self, keys, n_windows: None)


def _half_batch_doubled(monkeypatch, table):
    add = table.EpochTable.add

    def half(self, keys, n_windows):
        keys = keys.reshape(-1)
        h = keys[: keys.numel() // 2]
        add(self, h.repeat(2), n_windows)

    monkeypatch.setattr(table.EpochTable, "add", half)


def _answer_altered(monkeypatch, table):
    pull = table._pull_table

    def altered(*args):
        codes, counts = pull(*args)
        counts = counts.copy()
        counts[counts.shape[0] // 2] += np.uint64(1)
        return codes, counts

    monkeypatch.setattr(table, "_pull_table", altered)


def _pass_fails(monkeypatch, table):
    from portbench.entries import count_with_input

    real, calls = count_with_input.run, []

    def flaky(path, cfg):
        calls.append(1)
        if len(calls) == 2:  # the window's first pass (the first call warms up)
            raise RuntimeError("planted failure")
        return real(path, cfg)

    monkeypatch.setattr(count_with_input, "run", flaky)


@pytest.mark.parametrize("cell", ["readset_k21_clean", "assembly_k31_hist"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_doubled, _answer_altered,
                                   _pass_fails])
def test_a_fault_under_the_timed_path_is_not_correct(cpu_port, monkeypatch, cell, fault):
    fault(monkeypatch, cpu_port)
    out = run.run_cell(tiny_cell(cell), 2**31 + 29, SECONDS, False, CPU)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_an_altered_histogram_is_not_correct(cpu_port, monkeypatch):
    import krust_tpu_torch.output as output

    hist = output.compute_histogram_array

    def altered(counts):
        h = hist(counts)
        first = next(iter(h))
        h[first] += 1
        return h

    monkeypatch.setattr(output, "compute_histogram_array", altered)
    out = run.run_cell(tiny_cell("assembly_k31_hist"), 2**31 + 31, SECONDS, False, CPU)
    assert out["correct"] is False and out["checks"]["outputs_off"]["value"] >= 1
    assert out["checks"]["entries_off"]["value"] == 0


def test_control_readings_fail_where_the_programs_pass(cpu_port):
    from portbench import control

    for cell in ("readset_k21_clean", "assembly_k31_hist"):
        got = control.readings(tiny_cell(cell), 2**31 + 37, CPU)
        assert all(v == 0 for v in got["program"].values())
        assert got["control"]["entries_off"] > 0
        if "outputs_off" in got["control"]:
            assert got["control"]["outputs_off"] == 1
