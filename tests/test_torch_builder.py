"""The port's builder, async and memory-mapped entry points against krust_tpu.

Mirrors tests/test_builder.py and the mmap and async cases of
tests/test_api.py: each port entry point, counting through its
``BatchEngine`` on the CPU device (every kernel's plain version), must give
the same table as the same ``krust_tpu`` entry point on the same file.
Entry points that take no config reach the CPU device through a patched
``select_engine``; the builder through ``engine_config``.
"""

import asyncio
import io

import numpy as np
import pytest

import krust_tpu as kt
import krust_tpu_torch as pt
from krust_tpu_torch.errors import BuilderError
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.models import engines
from krust_tpu_torch.utils.config import EngineConfig

CPU = EngineConfig(block_windows=256, batch_rows=8, device="cpu")


@pytest.fixture(autouse=True)
def on_cpu_device(monkeypatch):
    """Every port count without a config runs the device engine on the CPU."""
    used = []

    def select(cfg):
        used.append(cfg)
        return engines.BatchEngine(CPU)

    monkeypatch.setattr(engines, "select_engine", select)
    return used


@pytest.fixture
def dirty_fq(tmp_path):
    """A FASTQ with more than 1/32 of its bases N or below Q20 (the dense
    path at -Q 20)."""
    rng = np.random.default_rng(31)
    lines = []
    for i in range(25):
        n = int(rng.integers(30, 300))
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
        seq[rng.random(n) < 0.05] = ord("N")
        q = np.where(rng.random(n) < 0.05, ord("#"), ord("I")).astype(np.uint8)
        lines += [f"@r{i}", seq.tobytes().decode(), "+", q.tobytes().decode()]
    path = tmp_path / "dirty.fq"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _builder(k):
    return pt.KmerCounter.new().k(k).engine_config(CPU)


# --- builder (tests/test_builder.py) ------------------------------------------


@pytest.mark.parametrize("k", [3, 21])
def test_builder_basic(simple_fa, k):
    assert _builder(k).count(simple_fa) == kt.KmerCounter.new().k(k).count(simple_fa)


def test_builder_requires_k(simple_fa):
    with pytest.raises(BuilderError):
        pt.KmerCounter.new().count(simple_fa)


def test_builder_invalid_k():
    with pytest.raises(pt.KmerLengthError):
        pt.KmerCounter.new().k(0)


def test_builder_min_count(simple_fa):
    got = _builder(3).min_count(2).count(simple_fa)
    assert got == kt.KmerCounter.new().k(3).min_count(2).count(simple_fa)
    assert got and min(got.values()) >= 2


def test_builder_getters():
    b = (
        pt.KmerCounter.new()
        .k(5)
        .min_count(3)
        .format(pt.OutputFormat.TSV)
        .input_format(SequenceFormat.FASTQ)
        .min_quality(20)
    )
    assert b.get_k() == pt.KmerLength(5)
    assert b.get_min_count() == 3
    assert b.get_format() is pt.OutputFormat.TSV
    assert b.get_input_format() is SequenceFormat.FASTQ
    assert b.get_min_quality() == 20


def test_builder_min_quality_validation():
    with pytest.raises(BuilderError):
        pt.KmerCounter.new().min_quality(94)


def test_builder_histogram(simple_fa):
    assert _builder(3).histogram(simple_fa) == kt.KmerCounter.new().k(3).histogram(simple_fa)


def test_builder_streaming_and_mmap(simple_fa):
    exp = kt.KmerCounter.new().k(3).count(simple_fa)
    assert _builder(3).count(simple_fa) == exp
    assert _builder(3).count_streaming(simple_fa) == exp
    assert _builder(3).count_mmap(simple_fa) == exp


def test_builder_packed(simple_fa):
    assert _builder(7).count_packed(simple_fa) == kt.KmerCounter.new().k(7).count_packed(
        simple_fa
    )


def test_builder_quality_dense(dirty_fq):
    """-Q 20 on a dirty FASTQ: the dense path, through the builder."""
    got = _builder(21).min_quality(20).count(dirty_fq)
    assert got == kt.KmerCounter.new().k(21).min_quality(20).count(dirty_fq)


def test_builder_progress(simple_fa):
    snaps = []
    counts = _builder(3).count_with_progress(simple_fa, snaps.append)
    assert counts == kt.count_kmers(simple_fa, 3)
    assert snaps and snaps[-1].sequences_processed == 2


def test_builder_run_to_writer(simple_fa):
    got, exp = io.StringIO(), io.StringIO()
    _builder(3).format(pt.OutputFormat.TSV).count_to_writer(simple_fa, got)
    kt.KmerCounter.new().k(3).format(kt.OutputFormat.TSV).count_to_writer(simple_fa, exp)
    assert got.getvalue().strip() and got.getvalue() == exp.getvalue()


# --- async (tests/test_builder.py) -----------------------------------------------


def test_async_count(simple_fa, on_cpu_device):
    got = asyncio.run(pt.count_kmers_async(simple_fa, 3))
    assert got == asyncio.run(kt.count_kmers_async(simple_fa, 3))
    assert on_cpu_device


def test_async_packed(simple_fa):
    got = asyncio.run(pt.count_kmers_packed_async(simple_fa, 9))
    assert got == asyncio.run(kt.count_kmers_packed_async(simple_fa, 9))


def test_async_invalid_k(simple_fa):
    with pytest.raises(pt.KmerLengthError):
        asyncio.run(pt.count_kmers_async(simple_fa, 0))


@pytest.mark.parametrize("min_quality", [None, 20])
def test_async_builder(dirty_fq, min_quality):
    counter = pt.AsyncKmerCounter.new().k(5).min_count(2).min_quality(min_quality)
    ref = kt.AsyncKmerCounter.new().k(5).min_count(2).min_quality(min_quality)
    got = asyncio.run(counter.count(dirty_fq))
    assert got and got == asyncio.run(ref.count(dirty_fq))


def test_async_builder_requires_k(simple_fa):
    with pytest.raises(BuilderError):
        asyncio.run(pt.AsyncKmerCounter.new().count(simple_fa))


# --- mmap (tests/test_api.py) ----------------------------------------------------


@pytest.mark.parametrize("k", [5, 21])
def test_mmap_equals_regular(simple_fa, k):
    got = pt.count_kmers_mmap(simple_fa, k, CPU)
    assert got == kt.count_kmers_mmap(simple_fa, k) == kt.count_kmers(simple_fa, k)


def test_mmap_handles_with_n(fixtures_dir):
    path = fixtures_dir / "with_n.fa"
    got = pt.count_kmers_mmap(path, 4, CPU)
    assert got and got == kt.count_kmers_mmap(path, 4)


def test_mmap_dirty_dense(tmp_path):
    """A FASTA with 10% Ns: the dense path, through the mmap entry point."""
    rng = np.random.default_rng(8)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)].copy()
    seq[rng.random(5000) < 0.1] = ord("N")
    path = tmp_path / "dirty.fa"
    path.write_bytes(b">d\n" + seq.tobytes() + b"\n")
    got = pt.count_kmers_mmap(path, 17, CPU)
    assert got and got == kt.count_kmers_mmap(path, 17)


def test_mmap_empty_file(tmp_path):
    p = tmp_path / "empty.fa"
    p.write_bytes(b"")
    assert pt.count_kmers_mmap(p, 5, CPU) == kt.count_kmers_mmap(p, 5) == {}


class TestMmapFasta:
    """The public mmap type (tests/test_api.py TestMmapFasta)."""

    def test_open_and_read(self, simple_fa):
        with pt.MmapFasta.open(simple_fa) as m, kt.MmapFasta.open(simple_fa) as r:
            assert not m.is_empty()
            assert bytes(m.as_bytes()) == bytes(r.as_bytes())
            assert bytes(m.as_bytes()[:5]) == b">seq1"

    def test_len(self, tmp_path):
        p = tmp_path / "t.fa"
        p.write_bytes(b"ACGT")
        with pt.MmapFasta.open(p) as m:
            assert m.len() == 4 and len(m) == 4

    def test_empty_file(self, tmp_path):
        p = tmp_path / "empty.fa"
        p.write_bytes(b"")
        with pt.MmapFasta.open(p) as m:
            assert m.is_empty() and m.len() == 0
            assert bytes(m.as_bytes()) == b""

    def test_nonexistent_file_error(self, tmp_path):
        with pytest.raises(OSError):
            pt.MmapFasta.open(tmp_path / "nonexistent_file.fa")

    def test_close_idempotent_and_repr(self, simple_fa):
        m = pt.MmapFasta.open(simple_fa)
        assert not m.closed and "bytes" in repr(m)
        m.close()
        m.close()
        assert m.closed and "closed" in repr(m)

    def test_zero_copy_parse(self, simple_fa):
        from krust_tpu_torch.io.reader import parse_to_streams

        with pt.MmapFasta.open(simple_fa) as m:
            streams = parse_to_streams(m.as_bytes(), SequenceFormat.FASTA)
        assert streams.n_records == 2
