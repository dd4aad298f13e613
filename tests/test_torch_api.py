"""Every public function of ``krust_tpu_torch.api`` against krust_tpu's.

One parametrised test over the module's whole public surface (a new public
function without a case fails ``test_every_public_function_has_a_case``):
each call, on the port's device engine on the CPU (``select_engine``
patched; an explicit ``EngineConfig(device="cpu")`` where the function
takes a config), must equal the same ``krust_tpu.api`` call on its XLA-CPU
device engine on the same input: gzip FASTQ where the function takes a
path (plain FASTA for the memory map), a ``BytesIO`` behind ``sys.stdin``
for the stdin functions. Also the progress snapshots on both ingest paths
and the bounded reads of ``count_kmers_from_reader``. Exact: equal dicts,
equal tables, equal printed bytes.
"""

import gzip
import inspect
import io
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest

import krust_tpu.api as jax_api
import krust_tpu.utils.config as jax_config
import krust_tpu_torch.api as port_api
from krust_tpu.io.format import SequenceFormat as JaxFormat
from krust_tpu.io.input import Input as JaxInput
from krust_tpu.output import OutputFormat as JaxOutput
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.io.input import Input
from krust_tpu_torch.models import engines
from krust_tpu_torch.output import OutputFormat
from krust_tpu_torch.utils.config import EngineConfig

K = 17
GEOMETRY = dict(block_windows=256, batch_rows=8)
CPU = EngineConfig(device="cpu", **GEOMETRY)
JAX = jax_config.EngineConfig(**GEOMETRY)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def port_on_cpu_device(monkeypatch):
    """Port counts without a config run the device engine on the CPU."""
    used = []

    def select(cfg):
        used.append(cfg)
        return engines.BatchEngine(replace(cfg, device="cpu", **GEOMETRY))

    monkeypatch.setattr(engines, "select_engine", select)
    return used


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded reads: FASTQ (plain and gzip) with Ns, soft-masking and low
    quality bases, and the same records as FASTA."""
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fq, fa, seqs = [], [], []
    for i in range(30):
        n = int(rng.integers(10, 300))
        s = acgt[rng.integers(0, 4, n)].copy()
        s[rng.random(n) < 0.01] = ord("N")
        s[rng.random(n) < 0.05] += 32
        q = np.where(rng.random(n) < 0.03, ord("#"), ord("I")).astype(np.uint8)
        seq = s.tobytes().decode()
        seqs.append(seq)
        fq.append(f"@r{i}\n{seq}\n+\n{q.tobytes().decode()}\n")
        fa.append(f">r{i}\n{seq[:100]}\n{seq[100:]}\n" if n > 100 else f">r{i}\n{seq}\n")
    d = tmp_path_factory.mktemp("api")
    fq_bytes, fa_bytes = "".join(fq).encode(), "".join(fa).encode()
    with gzip.open(d / "reads.fq.gz", "wb") as f:
        f.write(fq_bytes)
    (d / "reads.fa").write_bytes(fa_bytes)
    return {"fq_gz": str(d / "reads.fq.gz"), "fa": str(d / "reads.fa"),
            "fq_bytes": fq_bytes, "fa_bytes": fa_bytes, "seqs": seqs}


def _stdin(monkeypatch, raw: bytes):
    class _In:
        buffer = io.BytesIO(raw)

    monkeypatch.setattr(sys, "stdin", _In())


def _table(result):
    return (result.k, result.codes.tolist(), result.counts.tolist())


def _printed(fn, capsys):
    fn()
    return capsys.readouterr().out


# name -> case(api, data, monkeypatch, capsys, port) -> comparable value;
# ``api`` is krust_tpu.api or krust_tpu_torch.api, ``port`` says which
def _cfg(port, **kw):
    return replace(CPU, **kw) if port else replace(JAX, **kw)


def _fmt(port, name):
    return getattr(SequenceFormat if port else JaxFormat, name)


def _input(port, path):
    return (Input if port else JaxInput).from_path(path)


def _out(port, name):
    return getattr(OutputFormat if port else JaxOutput, name)


def _stringio_run(fn):
    out = io.StringIO()
    fn(out)
    return out.getvalue()


CASES = {
    "count_kmers": lambda a, d, mp, cs, p: a.count_kmers(d["fq_gz"], K),
    "count_kmers_with_format": lambda a, d, mp, cs, p: a.count_kmers_with_format(
        d["fq_gz"], K, _fmt(p, "FASTQ")),
    "count_kmers_with_quality": lambda a, d, mp, cs, p: a.count_kmers_with_quality(
        d["fq_gz"], K, _fmt(p, "AUTO"), 20),
    "count_kmers_with_progress": lambda a, d, mp, cs, p: a.count_kmers_with_progress(
        d["fq_gz"], K, lambda snap: None),
    "count_kmers_mmap": lambda a, d, mp, cs, p: a.count_kmers_mmap(
        d["fa"], K, _cfg(p)),
    "count_kmers_files": lambda a, d, mp, cs, p: a.count_kmers_files(
        [d["fq_gz"], d["fa"], d["fq_gz"]], K, min_quality=20,
        config=_cfg(p, ingest_chunk_bytes=900)),
    "count_kmers_sniffed": lambda a, d, mp, cs, p: a.count_kmers_sniffed(d["fq_gz"], K),
    "count_kmers_sharded": lambda a, d, mp, cs, p: a.count_kmers_sharded(
        d["fq_gz"], K, min_quality=20, config=_cfg(p)),
    "count_kmers_sharded_result": lambda a, d, mp, cs, p: _table(
        a.count_kmers_sharded_result(d["fq_gz"], K, config=_cfg(p))),
    "count_kmers_streaming": lambda a, d, mp, cs, p: a.count_kmers_streaming(
        d["fq_gz"], K),
    "count_kmers_streaming_packed": lambda a, d, mp, cs, p: a.count_kmers_streaming_packed(
        d["fq_gz"], K),
    "count_kmers_packed": lambda a, d, mp, cs, p: a.count_kmers_packed(d["fq_gz"], K),
    "count_kmers_sequential": lambda a, d, mp, cs, p: a.count_kmers_sequential(
        d["fq_gz"], K),
    "count_kmers_from_reader": lambda a, d, mp, cs, p: a.count_kmers_from_reader(
        io.BytesIO(d["fa_bytes"]), K, config=_cfg(p, ingest_chunk_bytes=500)),
    "count_kmers_from_reader_packed": lambda a, d, mp, cs, p:
        a.count_kmers_from_reader_packed(io.StringIO(d["fq_bytes"].decode()), K,
                                         _fmt(p, "FASTQ")),
    "count_kmers_from_reader_packed_result": lambda a, d, mp, cs, p: _table(
        a.count_kmers_from_reader_packed_result(
            io.BytesIO(d["fq_bytes"]), K, _fmt(p, "FASTQ"),
            _cfg(p, ingest_chunk_bytes=700, use_epoch_sort=False))),
    "count_kmers_stdin": lambda a, d, mp, cs, p: (
        _stdin(mp, d["fa_bytes"]), a.count_kmers_stdin(K))[1],
    "count_kmers_stdin_with_format": lambda a, d, mp, cs, p: (
        _stdin(mp, d["fq_bytes"]), a.count_kmers_stdin_with_format(
            K, _fmt(p, "FASTQ")))[1],
    "count_kmers_stdin_packed": lambda a, d, mp, cs, p: (
        _stdin(mp, d["fa_bytes"]), a.count_kmers_stdin_packed(K))[1],
    "count_kmers_from_input": lambda a, d, mp, cs, p: (
        a.count_kmers_from_input(_input(p, d["fq_gz"]), K),
        _stdin(mp, d["fa_bytes"]), a.count_kmers_from_input(_input(p, "-"), K)),
    "count_kmers_from_input_packed": lambda a, d, mp, cs, p: (
        a.count_kmers_from_input_packed(_input(p, d["fq_gz"]), K),
        _stdin(mp, d["fa_bytes"]), a.count_kmers_from_input_packed(_input(p, "-"), K)),
    "count_kmers_from_sequences": lambda a, d, mp, cs, p: a.count_kmers_from_sequences(
        d["seqs"], K),
    "count_kmers_from_sequences_packed": lambda a, d, mp, cs, p:
        a.count_kmers_from_sequences_packed([s.encode() for s in d["seqs"]], K),
    "run": lambda a, d, mp, cs, p: _printed(lambda: a.run(d["fq_gz"], K), cs),
    "run_with_options": lambda a, d, mp, cs, p: _stringio_run(
        lambda out: a.run_with_options(d["fq_gz"], K, _out(p, "JSON"), 2, out)),
    "run_with_input": lambda a, d, mp, cs, p: _stringio_run(
        lambda out: a.run_with_input(_input(p, d["fq_gz"]), K, _out(p, "TSV"), 1, out)),
    "run_with_input_format": lambda a, d, mp, cs, p: (
        _stdin(mp, d["fq_bytes"]), _stringio_run(
            lambda out: a.run_with_input_format(_input(p, "-"), K, _out(p, "FASTA"), 1,
                                                _fmt(p, "FASTQ"), out)))[1],
    "run_with_quality": lambda a, d, mp, cs, p: _stringio_run(
        lambda out: a.run_with_quality(_input(p, d["fq_gz"]), K, _out(p, "HISTOGRAM"), 1,
                                       _fmt(p, "AUTO"), 20, out,
                                       _cfg(p, ingest_chunk_bytes=800))),
    "count_with_input": lambda a, d, mp, cs, p: _table(a.count_with_input(
        _input(p, d["fq_gz"]), K, _fmt(p, "AUTO"), 20, _cfg(p, use_epoch_sort=False))),
}


def _public_functions(module):
    return sorted(
        name for name, obj in vars(module).items()
        if inspect.isfunction(obj) and not name.startswith("_")
        and obj.__module__ == module.__name__
    )


def test_every_public_function_has_a_case():
    names = _public_functions(port_api)
    assert names == sorted(CASES) == _public_functions(jax_api)
    assert len(names) == 29


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_function_matches_krust_tpu(data, monkeypatch, capsys, port_on_cpu_device,
                                           name):
    got = CASES[name](port_api, data, monkeypatch, capsys, True)
    exp = CASES[name](jax_api, data, monkeypatch, capsys, False)
    assert got == exp
    assert got  # every case counts or prints something
    if name != "count_kmers_sequential" and "_sharded" not in name:
        # engine selection gave the device engine (the sharded count takes
        # its device from the config, the sequential engine is host code)
        assert port_on_cpu_device


@pytest.mark.parametrize("path_key", ["fq_gz", "fa"])
@pytest.mark.parametrize("chunked", [False, True], ids=["eager", "chunked"])
def test_progress_snapshots(data, path_key, chunked):
    """Progress on both ingest paths: monotone, and its last snapshot
    carries the same totals as krust_tpu's."""
    path = data[path_key]
    snaps, jax_snaps = [], []
    chunk = 600 if chunked else None
    port_api._count_path(path, K, config=replace(CPU, ingest_chunk_bytes=chunk),
                         progress=snaps.append)
    jax_api._count_path(path, K, config=replace(JAX, ingest_chunk_bytes=chunk),
                        progress=jax_snaps.append)
    assert len(snaps) > 1
    for name in ("sequences_processed", "bases_processed"):
        values = [getattr(s, name) for s in snaps]
        assert values == sorted(values)
        assert values[-1] == getattr(jax_snaps[-1], name)
    assert snaps[-1].sequences_processed == 30


def test_progress_exact_cadence(data):
    """``exact_cadence=True``: one snapshot a record, as krust_tpu's."""
    snaps, jax_snaps = [], []
    got = port_api.count_kmers_with_progress(data["fa"], K, snaps.append, True)
    exp = jax_api.count_kmers_with_progress(data["fa"], K, jax_snaps.append, True)
    assert got == exp
    assert [(s.sequences_processed, s.bases_processed) for s in snaps] == \
        [(s.sequences_processed, s.bases_processed) for s in jax_snaps]
    assert len(snaps) == 30


class _ChunkOnlyReader:
    """A pipe stand-in that refuses a read without a size."""

    def __init__(self, raw: bytes):
        self._buf = io.BytesIO(raw)
        self.max_request = 0

    def read(self, n: int = -1) -> bytes:
        assert n is not None and n > 0, "unbounded read() on a pipe reader"
        self.max_request = max(self.max_request, n)
        return self._buf.read(n)


def test_from_reader_never_slurps(data):
    reader = _ChunkOnlyReader(data["fa_bytes"])
    got = port_api.count_kmers_from_reader(reader, K, config=replace(
        CPU, ingest_chunk_bytes=512))
    assert reader.max_request <= 512
    assert got == jax_api.count_kmers_from_reader(io.BytesIO(data["fa_bytes"]), K)


def test_streaming_never_reads_the_file_whole(data, monkeypatch):
    """``count_kmers_streaming`` goes through chunks, never the eager read."""

    def boom(*a, **kw):
        raise AssertionError("the streaming API read the file whole")

    monkeypatch.setattr(port_api, "read_input_bytes", boom)
    monkeypatch.setattr(port_api, "DEFAULT_STREAMING_CHUNK_BYTES", 512)
    got = port_api.count_kmers_streaming(data["fq_gz"], K)
    assert got == jax_api.count_kmers(data["fq_gz"], K)


@pytest.mark.parametrize("method", ["count", "count_packed", "count_streaming",
                                    "histogram"])
def test_builder_routes_into_the_chunked_path(data, monkeypatch, method):
    """``KmerCounter`` with ``ingest_chunk_bytes`` in its engine config (or
    ``count_streaming``, chunked by default) counts through
    ``count_chunked_streams``, equal to krust_tpu's builder."""
    import krust_tpu
    import krust_tpu_torch

    chunked = []
    real = engines.count_chunked_streams
    monkeypatch.setattr(engines, "count_chunked_streams",
                        lambda *a, **kw: chunked.append(1) or real(*a, **kw))
    monkeypatch.setattr(port_api, "DEFAULT_STREAMING_CHUNK_BYTES", 600)
    chunk = None if method == "count_streaming" else 600
    got = getattr(krust_tpu_torch.KmerCounter.new().k(K).min_quality(20).engine_config(
        replace(CPU, ingest_chunk_bytes=chunk)), method)(data["fq_gz"])
    exp = getattr(krust_tpu.KmerCounter.new().k(K).min_quality(20).engine_config(
        replace(JAX, ingest_chunk_bytes=600)), method)(data["fq_gz"])
    assert chunked and got == exp and got
