"""The port's counting slice end to end, against the JAX package and the oracle.

``krust_tpu_torch``'s ``BatchEngine`` on ``device="cpu"`` (every kernel's
plain PyTorch version) against ``krust_tpu``'s ``BatchEngine`` on XLA-CPU
(interpret-mode kernels) and the brute-force oracle in ``tests/oracle.py``:
the fixtures, random FASTA/FASTQ with Ns, soft-masking and ``min_quality``,
k in {5, 16, 21, 32}, and a forced multi-epoch count. Full tables must be
equal (integer work: tolerance 0). Also: the CLI as a black box, the port's
import isolation from jax, engine selection, the feed thread, the table's
entry limits and the key conversions.
"""

import ast
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import krust_tpu.api as jax_api
import krust_tpu.utils.config as jax_config
import krust_tpu_torch.api as port_api
from krust_tpu_torch.io.input import Input
from krust_tpu_torch.io.reader import ParsedStreams, parse_records, read_input_bytes
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.kmer import INVALID_CODE
from krust_tpu_torch.models import engines
from krust_tpu_torch.models.engines import BatchEngine, NativeEngine, NumpyEngine
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.keys import (
    codes_to_keys, keys_to_codes, parts_from_numpy, parts_to_numpy,
)
from krust_tpu_torch.utils.config import EngineConfig

from oracle import count_sequences

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "krust_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _port(path, k, min_quality=None, **cfg):
    config = EngineConfig(block_windows=256, batch_rows=8, device="cpu", **cfg)
    return port_api.count_with_input(Input.from_path(path), k, min_quality=min_quality,
                                     config=config)


def _jax(path, k, min_quality=None):
    config = jax_config.EngineConfig(block_windows=256, batch_rows=8)
    return jax_api.count_with_input(
        jax_api.Input.from_path(path), k, min_quality=min_quality, config=config
    )


def _oracle(path, k, min_quality=None):
    fmt = SequenceFormat.AUTO.resolve(path)
    recs = parse_records(read_input_bytes(path), fmt)
    use_q = min_quality is not None and not fmt.is_fasta
    items = [
        (r.seq.decode(), r.qual.decode()) if use_q else r.seq.decode() for r in recs
    ]
    return count_sequences(items, k, min_quality if use_q else None)


def _check(path, k, min_quality=None):
    got = _port(path, k, min_quality)
    exp = _jax(path, k, min_quality)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert got.to_string_dict() == _oracle(path, k, min_quality)


@pytest.mark.parametrize("k", [5, 16, 21, 32])
@pytest.mark.parametrize(
    "name,min_quality",
    [("simple.fa", None), ("with_n.fa", None), ("soft_masked.fa", None),
     ("with_n.fq", None), ("low_quality.fq", 20)],
)
def test_fixtures_match_jax_and_oracle(fixtures_dir, name, min_quality, k):
    _check(str(fixtures_dir / name), k, min_quality)


def _write_random(path, rng, n_rec, fastq, n_rate, soft_rate, lowq_rate):
    lines = []
    for i in range(n_rec):
        n = int(rng.integers(1, 400))
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        seq[rng.random(n) < n_rate] = ord("N")
        soft = rng.random(n) < soft_rate
        seq[soft] += 32
        s = seq.tobytes().decode()
        if fastq:
            q = np.where(rng.random(n) < lowq_rate, ord("#"), ord("I")).astype(np.uint8)
            lines += [f"@r{i}", s, "+", q.tobytes().decode()]
        else:
            lines += [f">r{i}", s[:200], s[200:]] if n > 200 else [f">r{i}", s]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("k", [5, 16, 21, 32])
@pytest.mark.parametrize(
    "fastq,n_rate,min_quality",
    [(False, 0.005, None), (True, 0.005, 20), (True, 0.1, 20)],
    ids=["fasta-flat", "fastq-q20-flat", "fastq-q20-dense"],
)
def test_random_inputs_match_jax_and_oracle(tmp_path, k, fastq, n_rate, min_quality):
    """Sparse and dirty invalids (the JAX package sends the dirty ones down
    its dense path; the port keeps them on the flat one)."""
    rng = np.random.default_rng(1000 * k + int(fastq) + int(100 * n_rate))
    path = tmp_path / ("r.fq" if fastq else "r.fa")
    _write_random(path, rng, 30, fastq, n_rate, 0.1, 0.005 if n_rate < 0.05 else 0.05)
    _check(str(path), k, min_quality)


@pytest.mark.parametrize("k", [16, 21])
def test_multi_epoch_matches_jax(tmp_path, monkeypatch, k):
    """Small epochs: several sort+RLE flushes and part merges."""
    rng = np.random.default_rng(77 + k)
    path = tmp_path / "r.fa"
    _write_random(path, rng, 60, False, 0.002, 0.0, 0.0)
    merges = []
    real = table_mod._merge_compact
    monkeypatch.setattr(
        table_mod, "_merge_compact", lambda *a: merges.append(1) or real(*a)
    )
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "700")
    got = _port(str(path), k)
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES")
    exp = _jax(str(path), k)
    assert len(merges) > 1
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


def test_cli_tsv_matches_jax_cli(tmp_path, monkeypatch, capsysbinary):
    """The port's CLI, counting through its BatchEngine on the CPU with
    small epochs (codec, sort, RLE and merges), against ``python -m
    krust_tpu`` on its XLA-CPU device engine."""
    path = str(tmp_path / "r.fq")
    _write_random(tmp_path / "r.fq", np.random.default_rng(21), 20, True, 0.01, 0.1, 0.01)
    used = []

    def select(cfg):
        used.append(1)
        return BatchEngine(EngineConfig(block_windows=256, batch_rows=8, device="cpu"))

    monkeypatch.setattr(engines, "select_engine", select)
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "700")
    merges = []
    real = table_mod._merge_compact
    monkeypatch.setattr(
        table_mod, "_merge_compact", lambda *a: merges.append(1) or real(*a)
    )
    from krust_tpu_torch import cli

    assert cli.main(["21", path, "-f", "tsv", "-q"]) == 0
    out = capsysbinary.readouterr().out
    assert used and merges
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES")
    env = dict(os.environ, KRUST_PLATFORM="cpu", KRUST_ENGINE="device",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    exp = subprocess.run(
        [sys.executable, "-m", "krust_tpu", "21", path, "-f", "tsv", "-q"],
        capture_output=True, env=env, timeout=300, check=True, cwd=REPO,
    ).stdout
    assert out and out == exp


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import krust_tpu_torch, krust_tpu_torch.cli, krust_tpu_torch.ops.table\n"
        "import krust_tpu_torch.models.engines\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'krust_tpu' or m.startswith('krust_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_no_source_imports_jax_or_krust_tpu():
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("jax", "jaxlib", "krust_tpu"), (f, n)


# --- engine selection and the feed --------------------------------------------


def test_select_engine(monkeypatch):
    monkeypatch.delenv("KRUST_ENGINE", raising=False)
    assert isinstance(engines.select_engine(EngineConfig(device="cpu")), BatchEngine)
    assert isinstance(
        engines.select_engine(EngineConfig(use_numpy_backend=True)), NumpyEngine
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert isinstance(engines.select_engine(EngineConfig()), NativeEngine)
    monkeypatch.setenv("KRUST_ENGINE", "device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.select_engine(EngineConfig())
    monkeypatch.setenv("KRUST_ENGINE", "bogus")
    with pytest.raises(ValueError):
        engines.select_engine(EngineConfig())


def test_dense_path_raises_on_cuda_device():
    """A block geometry the flat layout cannot hold needs the dense path,
    which is not ported (A8): the engine refuses it on every device, never
    routing it through plain ops. Dirty input stays on the flat path."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    codes[rng.random(5000) < 0.2] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 5000)
    eng = BatchEngine(EngineConfig(block_windows=260, batch_rows=8, device="cpu"))
    with pytest.raises(NotImplementedError, match="A8"):
        eng.count(s, 11)
    got = BatchEngine(EngineConfig(block_windows=256, batch_rows=8, device="cpu")).count(s, 11)
    exp = NumpyEngine().count(s, 11)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_feed_depths_agree(depth):
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 20_000, dtype=np.uint8)
    codes[rng.random(20_000) < 0.005] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 20_000)
    got = BatchEngine(
        EngineConfig(block_windows=256, batch_rows=8, device="cpu", feed_depth=depth)
    ).count(s, 13)
    exp = NumpyEngine().count(s, 13)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


def test_feed_thread_stops_when_consumer_raises():
    started = threading.Event()

    def gen():
        for i in range(1000):
            started.set()
            yield i

    feed = engines._Feed(gen(), lambda b: b, depth=2)
    with pytest.raises(KeyError):
        with feed:
            for item in feed:
                if item == 3:
                    raise KeyError(item)
    assert started.is_set()
    assert feed._thread is not None and not feed._thread.is_alive()


def test_feed_reraises_worker_error():
    def gen():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        with engines._Feed(gen(), lambda b: b, depth=2) as feed:
            list(feed)


# --- the table's limits and the key form --------------------------------------


def test_epoch_limit_env_and_scaling(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "12345")
    assert table_mod.epoch_entry_limit(cpu) == 12345
    t = table_mod.EpochTable(11, cpu)
    assert t._epoch_limit == 12345 and t._adaptive is False
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES")
    assert table_mod.epoch_entry_limit(cpu) == table_mod.EPOCH_ENTRY_LIMIT
    monkeypatch.setattr(table_mod, "_device_mem_bytes", lambda d: 80 << 30)
    assert table_mod.epoch_entry_limit(cpu) == 5 * table_mod.EPOCH_ENTRY_LIMIT
    monkeypatch.setattr(table_mod, "_device_mem_bytes", lambda d: 1 << 20)
    assert table_mod.epoch_entry_limit(cpu) == 1 << 20


def test_adaptive_epoch_shrinks_on_duplication(monkeypatch):
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES", raising=False)
    monkeypatch.setattr(table_mod, "EPOCH_ENTRY_LIMIT", 4096)
    monkeypatch.setattr(table_mod.EpochTable, "ADAPT_MIN", 64)
    rng = np.random.default_rng(55)
    motif = rng.integers(0, 4, 40, dtype=np.uint8)
    codes = np.concatenate([motif for _ in range(600)])
    s = ParsedStreams(codes, None, 1, codes.shape[0])
    eng = BatchEngine(EngineConfig(block_windows=256, batch_rows=8, device="cpu"))
    table = eng._make_table(9)
    epochs = []
    eng._feed_streams(s, 9, None, table, epochs, lambda w: None)
    assert table._adaptive is False and table._epoch_limit < 4096
    epochs.append(table.finalize())
    got = eng._merge_epochs(epochs, 9)
    exp = NumpyEngine().count(s, 9)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


def test_window_limit_flush(monkeypatch):
    rng = np.random.default_rng(19)
    codes = rng.integers(0, 4, 6000, dtype=np.uint8)
    s = ParsedStreams(codes, None, 1, 6000)
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 4096)
    got = BatchEngine(EngineConfig(block_windows=256, batch_rows=8, device="cpu")).count(s, 11)
    exp = NumpyEngine().count(s, 11)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


@pytest.mark.parametrize("k", [1, 16, 17, 32])
def test_key_conversions_round_trip(k):
    rng = np.random.default_rng(k)
    codes = np.sort(rng.integers(0, 1 << (2 * k), 500, dtype=np.uint64, endpoint=False)
                    if k < 32 else rng.integers(0, 2**63, 500, dtype=np.uint64) * 2 + 1)
    codes = np.append(codes, np.uint64(2**64 - 1))  # the sentinel sorts last
    keys = codes_to_keys(codes, k)
    assert keys.dtype == (np.int32 if k <= 16 else np.int64)
    assert np.all(keys[1:] >= keys[:-1])  # signed order == code order
    np.testing.assert_array_equal(
        keys_to_codes(keys, k), codes & np.uint64((1 << 32) - 1) if k <= 16 else codes
    )
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    cnt = rng.integers(0, 1 << 31, codes.shape[0]).astype(np.uint32)
    t_keys, t_cnt = parts_from_numpy(hi, lo, cnt, k)
    g_hi, g_lo, g_cnt = parts_to_numpy(t_keys, t_cnt, k)
    np.testing.assert_array_equal(g_lo, lo)
    np.testing.assert_array_equal(g_cnt, cnt)
    if k > 16:
        np.testing.assert_array_equal(g_hi, hi)
