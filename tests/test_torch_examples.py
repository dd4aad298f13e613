"""The port's examples, fuzz targets and soak, beside krust_tpu's.

Each ``examples/torch_*.py`` runs in process on a small seeded input, the
port counting on its device engine on the CPU (``select_engine``
patched), and must print what the matching ``examples/*.py`` prints on
``krust_tpu`` (XLA-CPU device engine): equal stdout; for the progress bar,
which prints only to stderr, its result lines. Then a short seeded run of
``fuzz/fuzz_targets_torch.py`` (as tests/test_properties.py runs
krust_tpu's targets) and of ``tools/soak_torch.py --device cpu``.
"""

import importlib.util
import os
import re
import runpy
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest

from krust_tpu_torch.models import engines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["basic_count", "async_count", "progress_bar", "streaming_large_file",
            "compare_with_jellyfish"]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def port_on_cpu_device(monkeypatch):
    used = []

    def select(cfg):
        used.append(cfg)
        return engines.BatchEngine(replace(cfg, device="cpu", block_windows=256,
                                           batch_rows=8))

    monkeypatch.setattr(engines, "select_engine", select)
    return used


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """Two seeded FASTA files of 40 reads each over one 2 kbase genome, so
    k-mers repeat."""
    rng = np.random.default_rng(23)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, 2000)]
    d = tmp_path_factory.mktemp("examples")
    paths = []
    for f in range(2):
        recs = []
        for i in range(40):
            s = int(rng.integers(0, 1800))
            seq = genome[s : s + int(rng.integers(50, 200))].copy()
            seq[rng.random(seq.shape[0]) < 0.01] = ord("N")
            recs.append(f">r{i}\n{seq.tobytes().decode()}\n")
        paths.append(str(d / f"reads{f}.fa"))
        with open(paths[-1], "w") as out:
            out.write("".join(recs))
    return paths


def _run_example(name, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    monkeypatch.setenv("PATH", "")  # no jellyfish: the example prints its summary
    try:
        runpy.run_path(os.path.join(REPO, "examples", name), run_name="__main__")
    except SystemExit as e:
        assert not e.code, e.code
    return capsys.readouterr()


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_matches_krust_tpu(fastas, capsys, monkeypatch, port_on_cpu_device,
                                   example):
    argv = {"async_count": [*fastas, "-k", "11"],
            "streaming_large_file": [fastas[0], "11", "2"]}.get(example, [fastas[0], "11"])
    got = _run_example(f"torch_{example}.py", argv, capsys, monkeypatch)
    exp = _run_example(f"{example}.py", argv, capsys, monkeypatch)
    assert port_on_cpu_device
    assert got.out == exp.out
    if example == "progress_bar":  # the results go to stderr, beside timings
        def results(err):
            lines = err.split("Unique k-mers:")[1].splitlines()
            return [lines[0]] + lines[lines.index("Top 10 k-mers:"):]

        assert results(got.err) == results(exp.err)
    else:
        assert got.out.strip()


def test_port_examples_import_only_the_port():
    for name in EXAMPLES:
        with open(os.path.join(REPO, "examples", f"torch_{name}.py")) as f:
            text = f.read()
        assert "krust_tpu_torch" in text
        for line in text.splitlines():
            if line.startswith(("import ", "from ")) and "krust_tpu" in line:
                assert "krust_tpu_torch" in line, (name, line)


def test_fuzz_targets_torch_in_suite():
    path = os.path.join(REPO, "fuzz", "fuzz_targets_torch.py")
    spec = importlib.util.spec_from_file_location("fuzz_targets_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert "krust_tpu_torch" in mod.Kmer.__module__
    mod.main(10_000)


def test_coverage_fuzz_torch_short_run():
    """A seeded run of the port's coverage-guided fuzzer (3000 inputs a
    target): every target passes and reaches edges of krust_tpu_torch."""
    path = os.path.join(REPO, "fuzz", "coverage_fuzz_torch.py")
    with open(path) as f:
        imports = [line for line in f.read().splitlines()
                   if line.startswith(("import ", "from "))]
    assert not [line for line in imports if "jax" in line or re.search(r"\bkrust_tpu\b", line)]
    out = subprocess.run([sys.executable, path, "3000", "all"], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    edges = [int(m) for m in re.findall(r"\] done: (\d+) total edges", out.stdout)]
    assert len(edges) == 3 and 0 < edges[0] <= edges[1] <= edges[2], out.stdout
    assert out.stdout.rstrip().endswith("coverage-guided fuzz passed")


def test_soak_on_the_cpu():
    """Three seeded trials of the soak on the kernels' plain versions."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak_torch.py"), "--device", "cpu",
         "--iters", "3", "--seed", "5"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, KRUST_ENGINE=""),
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 4 and '"soak": "passed"' in lines[-1]
    assert all('"equal": true' in line for line in lines[:3])
