"""``KRUST_PLATFORM`` in the port, as krust_tpu reads it: ``cpu`` runs the
batch engine and the sharded path on the CPU (the kernels' plain
versions), ``gpu`` or ``cuda`` asks for the CUDA device, unset leaves the
choice to ``torch.cuda.is_available()``; any other value raises."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from krust_tpu_torch import entry as entry_mod
from krust_tpu_torch.io.reader import streams_from_sequences
from krust_tpu_torch.models import engines as eng
from krust_tpu_torch.parallel.mesh import init_distributed, make_mesh
from krust_tpu_torch.parallel.sharded import count_sharded
from krust_tpu_torch.utils.config import EngineConfig, default_device, forced_platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seqs(n=6, length=300, seed=16):
    rng = np.random.default_rng(seed)
    return ["".join(np.array(list("ACGTN"))[rng.choice(5, length, p=[.24] * 4 + [.04])])
            for _ in range(n)]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
    monkeypatch.delenv("KRUST_ENGINE", raising=False)


@pytest.mark.parametrize("value, cuda, platform, device", [
    ("", False, None, "cpu"),
    ("", True, None, "cuda"),
    ("cpu", False, "cpu", "cpu"),
    ("CPU", True, "cpu", "cpu"),
    ("gpu", True, "cuda", "cuda"),
    ("cuda", True, "cuda", "cuda"),
])
def test_platform_and_default_device(monkeypatch, value, cuda, platform, device):
    monkeypatch.setenv("KRUST_PLATFORM", value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    assert forced_platform() == platform
    assert default_device() == torch.device(device)
    assert EngineConfig().resolved_device() == torch.device(device)
    assert EngineConfig(device="cpu").resolved_device() == torch.device("cpu")


@pytest.mark.parametrize("value", ["gpu", "cuda"])
def test_cuda_platform_without_cuda_raises(monkeypatch, value):
    monkeypatch.setenv("KRUST_PLATFORM", value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (forced_platform, default_device, make_mesh,
                 lambda: eng.select_engine(EngineConfig()),
                 lambda: entry_mod.entry()):
        with pytest.raises(RuntimeError, match=f"KRUST_PLATFORM={value}: no CUDA device"):
            call()


@pytest.mark.parametrize("value", ["tpu", "metal", "cpu,cuda"])
def test_other_values_raise(monkeypatch, value):
    monkeypatch.setenv("KRUST_PLATFORM", value)
    for call in (forced_platform, default_device, make_mesh,
                 lambda: eng.select_engine(EngineConfig())):
        with pytest.raises(ValueError, match="expected 'cpu', 'gpu' or 'cuda'"):
            call()
    # an explicit request that needs no platform does not read it
    assert isinstance(eng.select_engine(EngineConfig(use_numpy_backend=True)),
                      eng.NumpyEngine)


@pytest.mark.parametrize("cuda", [False, True])
def test_cpu_platform_device_engine_counts_on_the_cpu(monkeypatch, cuda):
    """KRUST_ENGINE=device is honoured under KRUST_PLATFORM=cpu, with or
    without a GPU, and counts what the numpy engine counts."""
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    monkeypatch.setenv("KRUST_ENGINE", "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    engine = eng.select_engine(EngineConfig(block_windows=128, batch_rows=4))
    assert isinstance(engine, eng.BatchEngine)
    assert engine.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    streams = streams_from_sequences(_seqs())
    got, exp = engine.count(streams, 11), eng.NumpyEngine().count(streams, 11)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


def test_cpu_platform_mesh_is_one_cpu_slot(monkeypatch):
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cpu = torch.device("cpu")
    mesh = make_mesh()
    assert (mesh.group, mesh.size, mesh.devices) == (None, 1, (cpu,))
    assert make_mesh(1) == mesh
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        make_mesh(2)
    assert make_mesh(devices=["cpu"] * 3).devices == (cpu,) * 3


def test_cpu_platform_sharded_count(monkeypatch):
    """The sharded entry counts on one CPU slot with no device named."""
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    streams = streams_from_sequences(_seqs())
    cfg = EngineConfig(block_windows=128, batch_rows=2)
    got, exp = count_sharded(streams, 13, config=cfg), eng.NumpyEngine().count(streams, 13)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


def test_cpu_platform_process_group_is_gloo_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        assert dist.get_backend() == "gloo"
        mesh = make_mesh()
        assert (mesh.size, mesh.devices) == (1, (torch.device("cpu"),))
        assert mesh.group is not None
    finally:
        dist.destroy_process_group()


def test_cpu_platform_entry(monkeypatch, capsys):
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, args = entry_mod.entry()
    assert all(t.device == torch.device("cpu") for t in args)
    assert entry_mod.main(["2"]) == 0
    assert "2 devices (cpu, cpu)" in capsys.readouterr().out


def test_cli_device_engine_on_the_cpu_matches_krust_tpu(tmp_path):
    """``KRUST_PLATFORM=cpu KRUST_ENGINE=device python -m krust_tpu_torch``
    prints krust_tpu's bytes."""
    path = tmp_path / "g.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(_seqs(n=40))))
    env = dict(os.environ, KRUST_PLATFORM="cpu", KRUST_ENGINE="device",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = {}
    for package in ("krust_tpu_torch", "krust_tpu"):
        out[package] = subprocess.run(
            [sys.executable, "-m", package, "21", str(path), "-f", "tsv", "-q"],
            capture_output=True, env=env, timeout=300, check=True, cwd=REPO,
        )
    assert out["krust_tpu_torch"].stdout and out["krust_tpu_torch"].stderr == b""
    assert out["krust_tpu_torch"].stdout == out["krust_tpu"].stdout
