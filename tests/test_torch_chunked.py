"""The port's chunked (bounded-memory) ingest against krust_tpu's.

Mirrors tests/test_chunked.py for both packages: ``_count_path`` with
``ingest_chunk_bytes`` (``io.reader.stream_input_chunks`` ->
``models.engines.count_chunked_streams`` -> ``BatchEngine.count_chunked``)
on multi-line FASTA, FASTQ, gzip FASTQ and stdin, at chunk sizes of 64 B,
700 B and 1 MiB, on both tables, k in {1, 16, 17, 32}, with and without
-Q 20. The port counts on its device engine on the CPU (every kernel's
plain version), ``krust_tpu`` on its XLA-CPU device engine, both with
small batches (``block_windows=256``, ``batch_rows=8``) and small epochs, so
epoch flushes fall inside chunks and parts merge across chunks. Integer
work: codes and counts must be exactly equal, chunked and eager, in both
packages.
"""

import gzip
import io
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest

import krust_tpu.api as jax_api
import krust_tpu.utils.config as jax_config
from krust_tpu.io.format import SequenceFormat as JaxFormat
import krust_tpu_torch.api as port_api
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.io.reader import stream_input_chunks
from krust_tpu_torch.models import engines
from krust_tpu_torch.models.engines import BatchEngine
from krust_tpu_torch.ops import codec as codec_mod
from krust_tpu_torch.ops import fused_codec as fused_mod
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.utils.config import EngineConfig
from krust_tpu_torch.utils.progress import ProgressTracker

import oracle

GEOMETRY = dict(block_windows=256, batch_rows=8)
CHUNKS = [64, 700, 1 << 20]
#: the flush test's geometry: a batch carries up to 2 x 256 keys, an epoch
#: (or the LSM table's pending parts) flushes at every second batch, and a
#: chunk of 6000 bytes holds several batches
FLUSH_GEOMETRY = dict(block_windows=256, batch_rows=2)
EPOCH_ENTRIES = "700"
PENDING_ENTRIES = "1000"
FLUSH_CHUNK = 6000


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture
def small_epochs(monkeypatch):
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", EPOCH_ENTRIES)
    monkeypatch.setenv("KRUST_PENDING_ENTRIES", PENDING_ENTRIES)


def _records(seed, n_rec=40, n_rate=0.004):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n_rec):
        n = int(rng.integers(0, 400))
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        seq[rng.random(n) < n_rate] = ord("N")
        soft = rng.random(n) < 0.05
        seq[soft] += 32
        qual = np.where(rng.random(n) < 0.02, ord("#"), ord("I")).astype(np.uint8)
        recs.append((seq.tobytes().decode(), qual.tobytes().decode()))
    return recs


def _fasta_bytes(recs):
    out = []
    for i, (s, _) in enumerate(recs):
        out.append(f">r{i}\n")
        # multi-line records exercise the FASTA cut logic
        out += [s[j : j + 37] + "\n" for j in range(0, len(s), 37)]
    return "".join(out).encode()


def _fastq_bytes(recs):
    return "".join(f"@r{i}\n{s}\n+\n{q}\n" for i, (s, q) in enumerate(recs)).encode()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """kind -> (path or None for stdin, raw bytes, explicit format)."""
    d = tmp_path_factory.mktemp("chunked")
    recs = _records(5)
    fa, fq = _fasta_bytes(recs), _fastq_bytes(recs)
    (d / "in.fa").write_bytes(fa)
    (d / "in.fq").write_bytes(fq)
    with gzip.open(d / "in.fq.gz", "wb") as f:
        f.write(fq)
    return {
        "fasta": (str(d / "in.fa"), fa, "auto"),
        "fastq": (str(d / "in.fq"), fq, "auto"),
        "fastq_gz": (str(d / "in.fq.gz"), fq, "auto"),
        "stdin": (None, fq, "fastq"),
    }


class _Stdin:
    """``sys.stdin`` stand-in: its ``buffer`` is a fresh BytesIO of ``data``."""

    def __init__(self, data: bytes):
        self.buffer = io.BytesIO(data)


def _port(path, data, fmt, k, q, chunk, lsm, monkeypatch):
    cfg = EngineConfig(device="cpu", ingest_chunk_bytes=chunk,
                       use_epoch_sort=not lsm, **GEOMETRY)
    if path is None:
        monkeypatch.setattr(sys, "stdin", _Stdin(data))
    return port_api._count_path(path, k, SequenceFormat(fmt), q, cfg)


def _jax(path, data, fmt, k, q, chunk, lsm, monkeypatch):
    cfg = jax_config.EngineConfig(ingest_chunk_bytes=chunk, use_epoch_sort=not lsm,
                                  **GEOMETRY)
    if path is None:
        monkeypatch.setattr(sys, "stdin", _Stdin(data))
    return jax_api._count_path(path, k, JaxFormat(fmt), q, cfg)


def _equal(a, b, what):
    np.testing.assert_array_equal(a.codes, b.codes, err_msg=what)
    np.testing.assert_array_equal(a.counts, b.counts, err_msg=what)


_eager_cache: dict = {}


def _jax_eager(inputs, kind, k, q, lsm, monkeypatch):
    key = (kind, k, q, lsm)
    if key not in _eager_cache:
        path, data, fmt = inputs[kind]
        _eager_cache[key] = _jax(path, data, fmt, k, q, 0, lsm, monkeypatch)
    return _eager_cache[key]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["fasta", "fastq", "fastq_gz", "stdin"])
@pytest.mark.parametrize("q", [None, 20], ids=["q0", "q20"])
@pytest.mark.parametrize("lsm", [False, True], ids=["epoch", "lsm"])
@pytest.mark.parametrize("k", [1, 16, 17, 32])
def test_chunked_matches_krust_tpu(inputs, monkeypatch, k, lsm, q, kind, chunk):
    """Port chunked == port eager == krust_tpu eager, and == krust_tpu
    chunked at 700 B (krust_tpu's XLA-CPU side compiles per shape: one
    chunk size keeps its compiles few)."""
    path, data, fmt = inputs[kind]
    got = _port(path, data, fmt, k, q, chunk, lsm, monkeypatch)
    _equal(got, _port(path, data, fmt, k, q, 0, lsm, monkeypatch), "port chunked != eager")
    _equal(got, _jax_eager(inputs, kind, k, q, lsm, monkeypatch),
           "port chunked != krust_tpu eager")
    if chunk == 700:
        _equal(got, _jax(path, data, fmt, k, q, chunk, lsm, monkeypatch),
               "port chunked != krust_tpu chunked")


def test_small_chunks_make_many_chunks(inputs):
    """The chunk sizes above cut the inputs into many record-aligned
    chunks (64 B: about one record each), and the chunks add up to the
    whole input."""
    path, data, _ = inputs["fasta"]
    for chunk, least in ((64, 30), (700, 10), (1 << 20, 1)):
        chunks = list(stream_input_chunks(path, SequenceFormat.AUTO, chunk))
        assert len(chunks) >= least
        assert sum(c.n_records for c in chunks) == data.count(b">")


@pytest.mark.parametrize("lsm", [False, True], ids=["epoch", "lsm"])
@pytest.mark.parametrize("k", [16, 21])
def test_flushes_inside_chunks_and_merges_across_them(inputs, monkeypatch, small_epochs,
                                                     k, lsm):
    """One chunk holds several batches, so a flush (epoch table) or a
    compaction (LSM table) lands between two batches of one chunk, and the
    finished parts of different chunks merge: the merge runs, as a spy
    on it shows; the table equals krust_tpu's."""
    path, data, fmt = inputs["fastq"]
    calls = {"flush": 0, "merge": 0, "adds_at_flush": [], "chunk": 0}
    real_flush = table_mod._epoch_concat_sort_rle
    real_merge = table_mod._merge_compact
    real_runs = table_mod.merge_runs

    def flush(parts):
        calls["flush"] += 1
        calls["adds_at_flush"].append(calls["chunk"])
        return real_flush(parts)

    def merge(a, b):
        calls["merge"] += 1
        return real_merge(a, b)

    def runs(keys, cnt):
        calls["flush"] += 1
        calls["adds_at_flush"].append(calls["chunk"])
        return real_runs(keys, cnt)

    monkeypatch.setattr(table_mod, "_epoch_concat_sort_rle", flush)
    monkeypatch.setattr(table_mod, "_merge_compact", merge)
    monkeypatch.setattr(table_mod, "merge_runs", runs)
    chunks = list(stream_input_chunks(path, SequenceFormat.AUTO, FLUSH_CHUNK))
    assert len(chunks) >= 2

    def counted():
        for c in chunks:
            calls["chunk"] += 1
            yield c

    cfg = EngineConfig(device="cpu", use_epoch_sort=not lsm, **FLUSH_GEOMETRY)
    got = BatchEngine(cfg).count_chunked(counted(), k, 20)
    # two flushes in one chunk (so one between two of its batches), and
    # flushes in more than one chunk
    per_chunk = np.bincount(calls["adds_at_flush"])
    assert per_chunk.max() >= 2 and np.count_nonzero(per_chunk) >= 2, per_chunk
    if not lsm:
        assert calls["merge"] > 0
    # krust_tpu at its default epoch size: small epochs would compile a
    # merge for every pair of part shapes on XLA-CPU
    monkeypatch.delenv("KRUST_EPOCH_ENTRIES")
    monkeypatch.delenv("KRUST_PENDING_ENTRIES")
    _equal(got, _jax(path, data, fmt, k, 20, FLUSH_CHUNK, lsm, monkeypatch), "krust_tpu")


@pytest.mark.parametrize("lsm", [False, True], ids=["epoch", "lsm"])
@pytest.mark.parametrize("k", [16, 17])
def test_chunks_route_flat_then_dense_into_one_table(tmp_path, monkeypatch, k, lsm):
    """A clean first chunk takes the flat path (K1's plain version), a
    second chunk with more than 1/32 of its bases N the dense path (K4's
    plain version); both feed one table, equal to krust_tpu's and to the
    oracle."""
    rng = np.random.default_rng(9)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    clean = [acgt[rng.integers(0, 4, 300)].tobytes().decode() for _ in range(6)]
    dirty = []
    for _ in range(6):  # shorter than the clean records: one chunk holds them
        s = acgt[rng.integers(0, 4, 200)].copy()
        s[rng.random(200) < 0.1] = ord("N")
        dirty.append(s.tobytes().decode())
    text = "".join(f">c{i}\n{s}\n" for i, s in enumerate(clean))
    cut = len(text)
    text += "".join(f">d{i}\n{s}\n" for i, s in enumerate(dirty))
    path = tmp_path / "mixed.fa"
    path.write_text(text)
    chunks = list(stream_input_chunks(str(path), SequenceFormat.AUTO, cut + 1))
    # the clean records make the first chunk (a chunk ends at the last
    # record start in its block, so the dirty records make two)
    assert [c.n_records for c in chunks] == [6, 5, 1]

    seen = []
    real_flat, real_dense = fused_mod.encode_windows, codec_mod.encode_dense
    monkeypatch.setattr(fused_mod, "encode_windows",
                        lambda *a: seen.append("flat") or real_flat(*a))
    monkeypatch.setattr(codec_mod, "encode_dense",
                        lambda *a: seen.append("dense") or real_dense(*a))
    got = port_api._count_path(
        str(path), k,
        config=EngineConfig(device="cpu", ingest_chunk_bytes=cut + 1,
                            use_epoch_sort=not lsm, **GEOMETRY),
    )
    assert seen and seen[0] == "flat" and seen[-1] == "dense"
    assert seen == sorted(seen, key=["flat", "dense"].index)
    _equal(got, _jax(str(path), None, "auto", k, None, cut + 1, lsm, monkeypatch),
           "krust_tpu")
    assert got.to_string_dict() == oracle.count_sequences(clean + dirty, k)


def test_progress_on_the_chunked_path(inputs):
    """Progress fires once per chunk, monotone, and ends at the input's
    exact totals: the same snapshots as krust_tpu's chunked engine."""
    from krust_tpu.io.reader import stream_input_chunks as jax_chunks
    from krust_tpu.models.engines import BatchEngine as JaxEngine
    from krust_tpu.utils.progress import ProgressTracker as JaxTracker

    path, data, _ = inputs["fasta"]
    snaps, jax_snaps = [], []
    BatchEngine(EngineConfig(device="cpu", **GEOMETRY)).count_chunked(
        stream_input_chunks(path, SequenceFormat.AUTO, 512), 5,
        progress=snaps.append, tracker=ProgressTracker())
    JaxEngine(jax_config.EngineConfig(**GEOMETRY)).count_chunked(
        jax_chunks(path, JaxFormat.AUTO, 512), 5,
        progress=jax_snaps.append, tracker=JaxTracker())
    assert len(snaps) >= 2
    assert snaps[-1].sequences_processed == data.count(b">")
    for name in ("sequences_processed", "bases_processed"):
        values = [getattr(s, name) for s in snaps]
        assert values == sorted(values)
        assert values == [getattr(s, name) for s in jax_snaps]


def test_read_sequences_span_is_chunked(inputs, monkeypatch):
    """The chunked path opens the ``read_sequences`` span with
    ``chunked=True`` (krust_tpu's field), and the eager path without it."""
    from krust_tpu_torch.utils import tracing

    seen = []

    def collect(kind, name, fields):
        if name == "read_sequences":
            seen.append(fields.get("chunked", False))

    path = inputs["fasta"][0]
    tracing.add_collector(collect)
    try:
        cfg = EngineConfig(device="cpu", **GEOMETRY)
        port_api._count_path(path, 5, config=replace(cfg, ingest_chunk_bytes=700))
        port_api._count_path(path, 5, config=cfg)
    finally:
        tracing.remove_collector(collect)
    assert seen == [True, False]


def test_stdin_defaults_to_chunks(inputs, monkeypatch):
    """Stdin with no ``ingest_chunk_bytes`` takes the chunked path in
    ``DEFAULT_STDIN_CHUNK_BYTES`` chunks (here patched small), on the
    engine ``select_engine`` gives: the device engine."""
    path, data, fmt = inputs["stdin"]
    sizes, used = [], []
    real = port_api.DEFAULT_STDIN_CHUNK_BYTES
    monkeypatch.setattr(port_api, "DEFAULT_STDIN_CHUNK_BYTES", 700)

    def select(cfg):
        used.append(cfg)
        return BatchEngine(EngineConfig(device="cpu", **GEOMETRY))

    import krust_tpu_torch.io.reader as reader_mod

    real_chunks = reader_mod.stream_input_chunks

    def chunks(p, f, chunk_bytes):
        sizes.append(chunk_bytes)
        return real_chunks(p, f, chunk_bytes)

    monkeypatch.setattr(engines, "select_engine", select)
    monkeypatch.setattr(reader_mod, "stream_input_chunks", chunks)
    monkeypatch.setattr(sys, "stdin", _Stdin(data))
    got = port_api._count_path(None, 17, SequenceFormat.FASTQ)
    assert sizes == [700] and used and real == 256 << 20
    monkeypatch.setattr(sys, "stdin", _Stdin(data))
    exp = jax_api._count_path(
        None, 17, JaxFormat.FASTQ, None,
        jax_config.EngineConfig(ingest_chunk_bytes=700, **GEOMETRY))
    _equal(got, exp, "krust_tpu")


@pytest.mark.slow
@pytest.mark.parametrize("lsm", [False, True], ids=["epoch", "lsm"])
@pytest.mark.parametrize("k", range(1, 33))
def test_chunked_all_k(inputs, monkeypatch, k, lsm):
    """Every k, FASTQ at -Q 20 in 700-byte chunks."""
    path, data, fmt = inputs["fastq"]
    got = _port(path, data, fmt, k, 20, 700, lsm, monkeypatch)
    _equal(got, _jax(path, data, fmt, k, 20, 700, lsm, monkeypatch), "krust_tpu")
