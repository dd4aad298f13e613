"""The port's counting slice end to end, against the JAX package and the oracle.

``krust_tpu_torch``'s ``BatchEngine`` on ``device="cpu"`` (every kernel's
plain PyTorch version) against ``krust_tpu``'s ``BatchEngine`` on XLA-CPU
(interpret-mode kernels) and the brute-force oracle in ``tests/oracle.py``:
the fixtures, random FASTA/FASTQ with Ns, soft-masking and ``min_quality``,
k in {5, 16, 21, 32}, and a forced multi-epoch count, on the flat path and
on the dense path (dirty and quality-masked streams, block geometries the
flat layout cannot hold, the 1/32 routing boundary), and the LSM table path
(``use_epoch_sort=False``) against the epoch table and ``krust_tpu``'s LSM
engine on both routes. Full tables must be equal (integer work: tolerance 0). Also: the CLI as a black box, the port's
import isolation from jax, engine selection, the feed thread, the table's
entry limits and the key conversions.
"""

import ast
import os
import re
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
from krust_tpu_torch.io import native as port_native
from krust_tpu_torch.io import packer as port_packer
from krust_tpu_torch.ops import codec as codec_mod
from krust_tpu_torch.ops import fused_codec as fused_mod
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.keys import (
    codes_to_keys, keys_to_codes, parts_from_numpy, parts_to_numpy, sentinel,
)
from krust_tpu_torch.utils.config import EngineConfig

from oracle import count_sequences

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "krust_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _port(path, k, min_quality=None, block_windows=256):
    config = EngineConfig(block_windows=block_windows, batch_rows=8, device="cpu")
    return port_api.count_with_input(Input.from_path(path), k, min_quality=min_quality,
                                     config=config)


def _jax(path, k, min_quality=None, block_windows=256):
    config = jax_config.EngineConfig(block_windows=block_windows, batch_rows=8)
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


def _check(path, k, min_quality=None, block_windows=256):
    got = _port(path, k, min_quality, block_windows)
    exp = _jax(path, k, min_quality, block_windows)
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
    """Sparse and dirty invalids (both packages send the dirty ones down
    their dense path)."""
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


# --- the LSM table path (use_epoch_sort=False) -----------------------------------


def _lsm_stream(kind, rng, n):
    """(codes, qual, min_quality, dense): clean, N-rich and quality-masked
    streams on the flat route, and their dirty twins on the dense route."""
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    qual, min_quality = None, None
    rate = {"clean": 0.0, "n-rich": 0.02, "n-rich-dense": 0.15}.get(kind)
    if rate is not None:
        codes[rng.random(n) < rate] = INVALID_CODE
    else:  # quality-masked: 2% (flat) or 15% (dense) of the bases below Q20
        low = 0.15 if kind == "quality-dense" else 0.02
        qual = np.where(rng.random(n) < low, ord("#"), ord("I")).astype(np.uint8)
        min_quality = 20
    return codes, qual, min_quality, kind.endswith("dense")


@pytest.mark.parametrize("k", [1, 16, 17, 32])
@pytest.mark.parametrize(
    "kind", ["clean", "n-rich", "quality", "n-rich-dense", "quality-dense"]
)
def test_lsm_table_engine_matches_epoch_table_and_jax(route, monkeypatch, kind, k):
    """``use_epoch_sort=False`` (the LSM DeviceTable, several compactions)
    equals the epoch-sort table equals ``krust_tpu``'s LSM engine, on both
    codec routes."""
    from krust_tpu.io.reader import ParsedStreams as JaxStreams
    from krust_tpu.models.engines import BatchEngine as JaxEngine

    rng = np.random.default_rng(500 + k + len(kind))
    codes, qual, min_quality, dense = _lsm_stream(kind, rng, 9000)
    if k == 32:
        codes[:600] = np.where(codes[:600] == INVALID_CODE, INVALID_CODE, 2)  # bit 63 set
    merges = []
    real = table_mod.merge_runs
    monkeypatch.setattr(table_mod, "merge_runs",
                        lambda keys, cnt: merges.append(1) or real(keys, cnt))
    got = {}
    for epoch_sort in (False, True):
        cfg = EngineConfig(block_windows=256, batch_rows=8, device="cpu",
                           use_epoch_sort=epoch_sort)
        got[epoch_sort] = BatchEngine(cfg).count(
            ParsedStreams(codes, qual, 1, 9000), k, min_quality)
    exp = JaxEngine(
        jax_config.EngineConfig(block_windows=256, batch_rows=8, use_epoch_sort=False)
    ).count(JaxStreams(codes, qual, 1, 9000), k, min_quality)
    for table in got.values():
        np.testing.assert_array_equal(table.codes, exp.codes)
        np.testing.assert_array_equal(table.counts, exp.counts)
    assert len(merges) >= 1  # only the LSM table merges runs
    assert (route["dense"] > 0) == dense and (route["flat"] > 0) == (not dense)


def test_lsm_table_engine_compacts_and_flushes(monkeypatch):
    """Five batches at max_parts = 8 stay pending until finalize; a pending
    limit below a batch compacts at every add; the window limit flushes the
    LSM table to the host accumulator as it does the epoch table."""
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, 9000, dtype=np.uint8)
    s = ParsedStreams(codes, None, 1, 9000)
    exp = NumpyEngine().count(s, 11)
    cfg = EngineConfig(block_windows=256, batch_rows=8, device="cpu", use_epoch_sort=False)
    merges = []
    real = table_mod.merge_runs
    monkeypatch.setattr(table_mod, "merge_runs",
                        lambda keys, cnt: merges.append(keys.numel()) or real(keys, cnt))
    for env, limit, n_merges in ((None, None, 1), ("1000", None, 5), (None, 4096, 5)):
        merges.clear()
        with monkeypatch.context() as m:
            if env:
                m.setenv("KRUST_PENDING_ENTRIES", env)
            if limit:
                m.setattr(table_mod, "EPOCH_WINDOW_LIMIT", limit)
            got = BatchEngine(cfg).count(s, 11)
        np.testing.assert_array_equal(got.codes, exp.codes)
        np.testing.assert_array_equal(got.counts, exp.counts)
        assert len(merges) == n_merges, (env, limit, merges)


@pytest.mark.parametrize("k", [5, 16, 17, 32])
def test_raw_parts_cross_with_zero_weight_padding(k):
    """A ``krust_tpu`` raw part pads with zero-weight entries under any key;
    the port's padding is the sentinel key with count 0, and back."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << min(2 * k, 63), 300, dtype=np.uint64)
    hi, lo = (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32)
    weight = rng.integers(0, 3, 300).astype(np.uint32)
    keys, cnt = parts_from_numpy(hi, lo, weight, k, zero_is_padding=True)
    assert torch.all((keys == sentinel(keys.dtype)) == (cnt == 0))
    kept, _ = parts_from_numpy(hi, lo, weight, k)  # a compacted part: keys as they are
    assert not torch.any(kept == sentinel(kept.dtype))
    g_hi, g_lo, g_cnt = parts_to_numpy(keys, cnt, k, zero_is_padding=True)
    live = weight > 0
    np.testing.assert_array_equal(g_cnt, weight)
    np.testing.assert_array_equal(g_lo, np.where(live, lo, 0))
    np.testing.assert_array_equal(g_hi, np.where(live, hi, 0))


# --- the dense path ------------------------------------------------------------


@pytest.fixture
def route(monkeypatch):
    """Counts the port's step calls by route: flat (K1) and dense (K4)."""
    calls = {"flat": 0, "dense": 0}
    real_flat, real_dense = fused_mod.encode_windows, codec_mod.encode_dense

    def flat(*a):
        calls["flat"] += 1
        return real_flat(*a)

    def dense(*a):
        calls["dense"] += 1
        return real_dense(*a)

    monkeypatch.setattr(fused_mod, "encode_windows", flat)
    monkeypatch.setattr(codec_mod, "encode_dense", dense)
    return calls


@pytest.mark.parametrize("k", [5, 16, 21, 32])
@pytest.mark.parametrize(
    "fastq,n_rate,lowq_rate,min_quality",
    [(False, 0.08, 0.0, None), (True, 0.005, 0.1, 20)],
    ids=["fasta-dirty", "fastq-q20-lowq"],
)
def test_dense_inputs_match_jax_and_oracle(tmp_path, route, k, fastq, n_rate, lowq_rate,
                                           min_quality):
    """More than 1/32 of the bases invalid (Ns, or below Q20): the dense
    path in both packages."""
    rng = np.random.default_rng(300 + k + int(fastq))
    path = tmp_path / ("r.fq" if fastq else "r.fa")
    _write_random(path, rng, 40, fastq, n_rate, 0.1, lowq_rate)
    _check(str(path), k, min_quality)
    assert route["dense"] > 0 and route["flat"] == 0


@pytest.mark.parametrize("k,block_windows", [(21, 8), (32, 8), (31, 16)])
def test_dense_geometry_matches_jax_and_oracle(tmp_path, route, k, block_windows):
    """block_windows < k - 1: the flat layout cannot hold the halo, so a
    clean stream takes the dense path too."""
    rng = np.random.default_rng(k + block_windows)
    path = tmp_path / "r.fa"
    _write_random(path, rng, 12, False, 0.005, 0.1, 0.0)
    _check(str(path), k, block_windows=block_windows)
    assert route["dense"] > 0 and route["flat"] == 0


@pytest.mark.parametrize("k", [16, 21])
def test_dense_multi_epoch_matches_jax(tmp_path, monkeypatch, route, k):
    """A dirty stream with small epochs: several flushes and part merges."""
    rng = np.random.default_rng(91 + k)
    path = tmp_path / "r.fa"
    _write_random(path, rng, 60, False, 0.1, 0.0, 0.0)
    merges = []
    real = table_mod._merge_compact
    monkeypatch.setattr(
        table_mod, "_merge_compact", lambda *a: merges.append(1) or real(*a)
    )
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "700")
    got = _port(str(path), k)
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES")
    exp = _jax(str(path), k)
    assert len(merges) > 1 and route["dense"] > 1 and route["flat"] == 0
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


@pytest.mark.parametrize("scan", ["native", "numpy"])
@pytest.mark.parametrize("extra", [0, 1], ids=["at-limit-flat", "one-more-dense"])
def test_flat_dense_boundary(monkeypatch, route, scan, extra):
    """n // 32 invalid bases stay on the flat path, one more goes dense, in
    both packages, with the native scan and the numpy one."""
    from krust_tpu.io.packer import flat_batches as jax_flat_batches

    if scan == "numpy":
        monkeypatch.setattr(port_native, "scan_pack_native", lambda *a: None)
    n = 32 * 200
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.choice(n, n // 32 + extra, replace=False)] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, n)
    flat = port_packer.flat_batches(codes, None, 11, None, 256, 8)
    assert (flat is None) == bool(extra)
    assert (jax_flat_batches(codes, None, 11, None, 256, 8) is None) == bool(extra)
    got = BatchEngine(EngineConfig(block_windows=256, batch_rows=8, device="cpu")).count(s, 11)
    exp = NumpyEngine().count(s, 11)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert (route["dense"] > 0, route["flat"] > 0) == (bool(extra), not extra)


def test_flat_batches_takes_a_prescan():
    """``prescanned=`` replaces the scan: a dirty stream scanned at
    max_inv = n stays flat, and its batches count it exactly."""
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, 3000, dtype=np.uint8)
    codes[rng.random(3000) < 0.2] = INVALID_CODE
    assert port_packer.flat_batches(codes, None, 9, None, 256, 8) is None
    scan = port_packer.flat_scan(codes, None, None, codes.shape[0])
    batches = list(port_packer.flat_batches(codes, None, 9, None, 256, 8, prescanned=scan))
    keys = torch.cat([
        fused_mod.encode_windows_plain(
            torch.from_numpy(np.concatenate([b.packed2, np.zeros(8, np.uint8)])),
            torch.from_numpy(b.invpos), b.covered, 9, b.rows * b.block_windows,
        )
        for b in batches
    ])
    uniq, cnt = torch.unique(keys[keys != sentinel(keys.dtype)], return_counts=True)
    exp = NumpyEngine().count(ParsedStreams(codes, None, 1, 3000), 9)
    np.testing.assert_array_equal(keys_to_codes(uniq.numpy(), 9), exp.codes)
    np.testing.assert_array_equal(cnt.numpy(), exp.counts)


def test_dense_progress_totals(tmp_path):
    rng = np.random.default_rng(12)
    path = tmp_path / "r.fa"
    _write_random(path, rng, 30, False, 0.1, 0.0, 0.0)
    snaps = []
    config = EngineConfig(block_windows=256, batch_rows=8, device="cpu")
    port_api._count_path(str(path), 13, config=config, progress=snaps.append)
    exp = port_api._read_streams(str(path), 13, SequenceFormat.AUTO)[1]
    assert len(snaps) > 1
    assert snaps[-1].sequences_processed == exp.n_records
    assert snaps[-1].bases_processed == exp.n_bases


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
        "import krust_tpu_torch.ops.count\n"
        "import krust_tpu_torch.models.engines\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'krust_tpu' or m.startswith('krust_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


def test_no_source_imports_jax_or_krust_tpu():
    """No module imports jax or krust_tpu, and no string of the code (a
    docstring aside) names a path into the krust_tpu directory."""
    into_ref = re.compile(r"(^|[/\\])krust_tpu([/\\]|$)")
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            docs = {
                id(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)
            }
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                elif (
                    isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                ):
                    assert not into_ref.search(node.value), (f, node.value)
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("jax", "jaxlib", "krust_tpu"), (f, n)


def test_native_core_is_the_ports_own_copy():
    """The port builds its own copy of the C++ core, byte-equal to the
    JAX package's, so the two host cores stay in sync."""
    assert os.path.dirname(port_native._SRC) == os.path.join(PKG, "io", "native")
    ref = os.path.join(REPO, "krust_tpu", "io", "native", "krust_native.cpp")
    with open(port_native._SRC, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_ptxas_report_parses_the_build_log(tmp_path, monkeypatch):
    """The kernels' registers, shared memory and spills come from the
    build's ptxas log, one row per entry function."""
    from krust_tpu_torch.ops import _cuda

    lib = tmp_path / "libk.so"
    (tmp_path / "libk.so.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z3fooPi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPi\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 38440 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3barv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 12 registers, used 0 barriers\n"
    )
    monkeypatch.setattr(_cuda, "_lib_path", lambda: str(lib))
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    assert _cuda.ptxas_report() == [
        {"kernel": "_Z3fooPi", "spill_store_bytes": 8, "spill_load_bytes": 4,
         "registers": 40, "smem_bytes": 38440},
        {"kernel": "_Z3barv", "spill_store_bytes": 0, "spill_load_bytes": 0,
         "registers": 12, "smem_bytes": 0},
    ]
    monkeypatch.setattr(_cuda, "_lib_path", lambda: str(tmp_path / "none.so"))
    assert _cuda.ptxas_report() == []


# --- engine selection and the feed --------------------------------------------


def test_select_engine(monkeypatch):
    monkeypatch.delenv("KRUST_ENGINE", raising=False)
    monkeypatch.delenv("KRUST_PLATFORM", raising=False)
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
    """A dirty stream, and a block geometry the flat layout cannot hold
    (block_windows < k - 1), now count on the dense path, equal to
    NumpyEngine and to krust_tpu; a geometry the dense packer refuses too
    (block_windows % 8) raises in both packages."""
    from krust_tpu.models.engines import BatchEngine as JaxBatchEngine

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    codes[rng.random(5000) < 0.2] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 5000)
    exp = NumpyEngine().count(s, 11)
    for w in (256, 8):
        got = BatchEngine(EngineConfig(block_windows=w, batch_rows=8, device="cpu")).count(s, 11)
        ref = JaxBatchEngine(jax_config.EngineConfig(block_windows=w, batch_rows=8)).count(s, 11)
        for table in (got, ref):
            np.testing.assert_array_equal(table.codes, exp.codes)
            np.testing.assert_array_equal(table.counts, exp.counts)
    eng = BatchEngine(EngineConfig(block_windows=260, batch_rows=8, device="cpu"))
    with pytest.raises(ValueError, match="multiple of 8"):
        eng.count(s, 11)
    with pytest.raises(AssertionError, match="multiple of 8"):
        JaxBatchEngine(jax_config.EngineConfig(block_windows=260, batch_rows=8)).count(s, 11)


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
    t = table_mod.EpochTable(11, device=cpu)
    assert t._epoch_limit == 12345 and t._adaptive is False
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES")
    assert table_mod.epoch_entry_limit(cpu) == table_mod.EPOCH_ENTRY_LIMIT
    # the limit is the H100's own; a card of twice its memory gets twice it
    monkeypatch.setattr(table_mod, "_device_mem_bytes", lambda d: table_mod._REFERENCE_MEM)
    assert table_mod.epoch_entry_limit(cpu) == table_mod.EPOCH_ENTRY_LIMIT
    monkeypatch.setattr(table_mod, "_device_mem_bytes", lambda d: 2 * table_mod._REFERENCE_MEM)
    assert table_mod.epoch_entry_limit(cpu) == 2 * table_mod.EPOCH_ENTRY_LIMIT
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
    lifetimes = engines._Lifetimes(eng._make_table(9), False)
    eng._feed_streams(s, 9, None, lifetimes, lambda w: None)
    table = lifetimes.table
    assert table._adaptive is False and table._epoch_limit < 4096
    got = lifetimes.result(9)
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
