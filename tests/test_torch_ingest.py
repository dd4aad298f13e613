"""The range-parallel ingest (``io/native/ingest.cpp``) and the read path
over it (``io/reader.read_streams``, ``api._read_streams``).

The ingest cuts its input at line starts into one range a thread, and each
range parses its own slice: its output must equal the one-thread C++ core's
(``native.parse_fastq_native`` / ``parse_fasta_native``) and the numpy
parse's byte for byte: codes, quality, record and base counts, and the
error. Thread counts are forced, so that cuts land at every FASTQ line
phase, inside multi-line FASTA records and on headers. Then the read path:
a regular file is parsed from a mapping gone before the call returns,
gzip, empty files, FIFOs and stdin are read, the quality stream is made
only where a count reads it, and the ``read_sequences`` span says which.
"""

import gzip
import io
import os
import random
import sys
import threading

import jax
import numpy as np
import pytest

import krust_tpu.api as jax_api
import krust_tpu.utils.config as jax_config
from krust_tpu.io.format import SequenceFormat as JaxFormat
import krust_tpu_torch.api as port_api
from krust_tpu_torch.errors import FormatError, ReadError
from krust_tpu_torch.io import native, reader
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.parallel.mesh import make_mesh
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig

THREADS = [1, 2, 3, 7, 8]
GEOMETRY = dict(block_windows=256, batch_rows=8)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _records(seed, n_rec, max_len):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n_rec):
        n = int(rng.integers(0, max_len))
        seq = np.frombuffer(b"ACGTNacgtnRY.", np.uint8)[rng.integers(0, 13, n)]
        qual = np.frombuffer(b"#+5FI", np.uint8)[rng.integers(0, 5, n)]
        recs.append((seq.tobytes(), qual.tobytes()))
    return recs


def _fastq(recs, nl=b"\n"):
    return b"".join(b"@r%d%s%s%s+%s%s%s" % (i, nl, s, nl, nl, q, nl)
                    for i, (s, q) in enumerate(recs))


def _fasta(recs, width=37, nl=b"\n"):
    out = []
    for i, (s, _) in enumerate(recs):
        out.append(b">r%d%s" % (i, nl))
        out += [s[j : j + width] + nl for j in range(0, len(s), width)]
    return b"".join(out)


_MANY = _records(3, 300, 120)
#: name -> (FASTQ?, input); every case parses, or raises, the same on all paths
CASES = {
    "fq_empty": (True, b""),
    "fq_one": (True, b"@a\nACGT\n+\nIIII\n"),
    "fq_no_final_newline": (True, b"@a\nACGT\n+\nIIII\n@b\nGG\n+\nII"),
    "fq_crlf": (True, _fastq(_records(1, 40, 60), b"\r\n")),
    "fq_lower_n_other": (True, b"@a\nacgtNnRYK.-*\x00\xff\n+x\nIIIIIIIIIIIIII\n@b\nA\n+\n#\n"),
    "fq_empty_sequence": (True, b"@a\n\n+\n\n@b\nAC\n+\nII\n"),
    "fq_many": (True, _fastq(_MANY)),
    "fa_empty": (False, b""),
    "fa_header_only": (False, b">a"),
    "fa_one_line": (False, b">a\nACGTN\n"),
    "fa_multiline": (False, _fasta(_MANY)),
    "fa_crlf": (False, _fasta(_records(2, 40, 200), 29, b"\r\n")),
    "fa_blank_lines": (False, b"\n\n>a\nAC\n\n\nGT\n>b\n\n>c\nac\r\n\n"),
    "fa_lower_n_other": (False, b">a x\nacgtNnRY.*\x00\xff\n>b\n>c\nA\n"),
    "fa_no_final_newline": (False, b">a\nACG\n>b\nTT"),
}
#: the core and the numpy parse count empty last lines differently (the
#: core strips one final terminator before it splits lines); the ingest
#: follows the core, which every caller with the native library uses
CORE_ONLY = {
    "fq_newline_only": (True, b"\n"),
    "fq_empty_final_quality": (True, b"@a\nACG\n+\nIII\n@b\n\n+\n\n\n"),
}

#: error code -> an input that first fails with it (the core's messages)
ERRORS = {
    1: (False, b"\n\nAC\n>a\nAC\n"),
    2: (True, b"@a\nAC\n+\nII\n@b\nAC\n"),
    3: (True, b"@a\nAC\n+\nII\nxb\nAC\n+\nII\n"),
    4: (True, b"@a\nAC\n+\nII\n@b\nAC\n-\nII\n"),
    5: (True, b"@a\nAC\n+\nII\n@b\nAC\n+\nIII\n"),
}


def _core(data, fastq):
    try:
        if fastq:
            codes, qual, n_rec, n_bases = native.parse_fastq_native(data)
            return codes.tobytes(), qual.tobytes(), n_rec, n_bases
        codes, n_rec, n_bases = native.parse_fasta_native(data)
        return codes.tobytes(), None, n_rec, n_bases
    except FormatError as e:
        return "error", str(e)


def _ingest(data, fastq, threads, quality=True):
    try:
        codes, qual, n_rec, n_bases, used = native.ingest_native(
            data, fastq, quality=quality, threads=threads)
    except FormatError as e:
        return "error", str(e)
    assert used == threads
    return codes.tobytes(), None if qual is None else qual.tobytes(), n_rec, n_bases


def _numpy(data, fastq, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "ingest_native", lambda *a, **k: None)
        try:
            s = reader.parse_to_streams(data, SequenceFormat.FASTQ if fastq else
                                        SequenceFormat.FASTA)
        except FormatError:
            return "error"
    return (s.codes.tobytes(), None if s.qual is None else s.qual.tobytes(), s.n_records,
            s.n_bases)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", list(CASES) + list(CORE_ONLY))
def test_ingest_matches_core_and_numpy(case, threads, monkeypatch):
    fastq, data = CASES.get(case) or CORE_ONLY[case]
    got = _ingest(data, fastq, threads)
    assert got[0] != "error"
    assert got == _core(data, fastq)
    if case in CASES:
        assert got == _numpy(data, fastq, monkeypatch)


def _uniform_fastq(n_rec):
    """Every line 4 bytes: with a thread a line, every line starts a range."""
    return b"".join(b"@r%d\n%s\n+x%d\n%s\n" % (i % 10, b"ACGT"[i % 4 :][:1] + b"gN",
                                            i % 10, b"I#F") for i in range(n_rec))


def _uniform_fasta(n_rec):
    return b"".join(b">r%d\nACG\nNtT\n" % (i % 10) for i in range(n_rec))


@pytest.mark.parametrize("threads", THREADS + [24])
@pytest.mark.parametrize("fastq", [True, False], ids=["fastq", "fasta"])
def test_cuts_at_every_line(fastq, threads):
    """Lines of one length and a thread a line cut the input at every line:
    every FASTQ line phase, every FASTA header, and inside FASTA records."""
    data = _uniform_fastq(6) if fastq else _uniform_fasta(6)
    assert {len(line) for line in data.split(b"\n")[:-1]} == {3}
    assert _ingest(data, fastq, threads) == _core(data, fastq)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("code", sorted(ERRORS))
def test_each_error_is_the_cores(code, threads):
    fastq, data = ERRORS[code]
    got = _ingest(data, fastq, threads)
    assert got == ("error", native._ERRORS[code])
    assert got == _core(data, fastq)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("order", [(4, 3), (3, 4), (5, 2), (3, 5)])
def test_first_error_in_file_order_wins(order, threads):
    """Two different faults far apart (in different ranges past one
    thread): the one earlier in the file is the error, as in the core."""
    recs = _records(7, 60, 40)
    lines = _fastq(recs).split(b"\n")
    plant = {3: lambda i: b"x" + lines[i][1:], 4: lambda i: b"-" + lines[i][1:],
             5: lambda i: lines[i] + b"I", 2: None}
    first, second = order
    for code, record in ((first, 8), (second, 50)):
        if code == 2:  # a partial record at the end
            lines = lines[: 4 * record + 2]
        else:
            i = 4 * record + {3: 0, 4: 2, 5: 3}[code]
            lines[i] = plant[code](i)
    data = b"\n".join(lines)
    expect = native._ERRORS[first]
    assert _ingest(data, True, threads) == ("error", expect) == _core(data, True)


@pytest.mark.parametrize("threads", THREADS)
def test_random_inputs_match_the_core(threads):
    """A seeded fuzz of small, often malformed inputs of both formats."""
    rng = random.Random(threads)
    alphabet = [b"A", b"c", b"N", b"x", b"\r", b"\n", b">", b"@", b"+", b"I"]
    for _ in range(400):
        if rng.random() < 0.5:
            data, fastq = _fastq(_records(rng.randrange(1 << 30), rng.randint(0, 6), 8),
                                 rng.choice([b"\n", b"\r\n"])), True
        else:
            data = b"\n".join(b"".join(rng.choice(alphabet) for _ in range(rng.randint(0, 8)))
                              for _ in range(rng.randint(0, 20)))
            data, fastq = (b">h\n" + data if rng.random() < 0.7 else data), False
        for _ in range(rng.randint(0, 2)):
            if data:
                i = rng.randrange(len(data))
                data = data[:i] + rng.choice(alphabet + [b""]) + data[i + 1 :]
        assert _ingest(data, fastq, threads) == _core(data, fastq), data


@pytest.mark.parametrize("threads", THREADS)
def test_no_quality_stream_without_quality(threads):
    """``quality=False``: the same codes and counts, no quality stream,
    and a quality line of the wrong length still fails."""
    fastq, data = CASES["fq_many"]
    full = _ingest(data, True, threads)
    codes, qual, n_rec, n_bases = _ingest(data, True, threads, quality=False)
    assert qual is None and (codes, n_rec, n_bases) == (full[0], full[2], full[3])
    bad = ERRORS[5][1]
    assert _ingest(bad, True, threads, quality=False) == ("error", native._ERRORS[5])
    fasta = _ingest(CASES["fa_multiline"][1], False, threads, quality=True)
    assert fasta[1] is None


def test_parse_to_streams_keeps_quality_by_default(monkeypatch):
    fastq, data = CASES["fq_many"]
    s = reader.parse_to_streams(data, SequenceFormat.FASTQ)
    assert s.qual is not None and s.qual.shape == s.codes.shape
    s = reader.parse_to_streams(data, SequenceFormat.FASTQ, quality=False)
    assert s.qual is None
    monkeypatch.setattr(native, "ingest_native", lambda *a, **k: None)
    assert reader.parse_to_streams(data, SequenceFormat.FASTQ, quality=False).qual is None
    with pytest.raises(FormatError):
        reader.parse_to_streams(ERRORS[5][1], SequenceFormat.FASTQ, quality=False)


def test_threads_from_size_cores_and_the_variable(monkeypatch):
    monkeypatch.delenv("KRUST_NATIVE_THREADS", raising=False)
    cores = len(os.sched_getaffinity(0))
    part = native.INGEST_PART_BYTES
    assert native.ingest_threads(0) == 1
    assert native.ingest_threads(part) == 1
    assert native.ingest_threads(part + 1) == min(2, cores)
    assert native.ingest_threads(3 * part) == min(3, cores)
    assert native.ingest_threads(1 << 40) == min(native.INGEST_MAX_THREADS, cores)
    monkeypatch.setenv("KRUST_NATIVE_THREADS", "5")
    assert native.ingest_threads(10) == 5
    monkeypatch.setenv("KRUST_NATIVE_THREADS", "1")
    assert native.ingest_threads(1 << 40) == 1


# --- the read path ---------------------------------------------------------------


class _Stdin:
    def __init__(self, data: bytes):
        self.buffer = io.BytesIO(data)


def _maps_of(path) -> list[str]:
    real = os.path.realpath(path)
    with open("/proc/self/maps") as f:
        return [line for line in f if line.rstrip().endswith(real)]


def _owns(arr) -> bool:
    while arr.base is not None:
        arr = arr.base
    return isinstance(arr, np.ndarray) and arr.flags.owndata


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    fq, fa = CASES["fq_many"][1], CASES["fa_multiline"][1]
    (d / "in.fq").write_bytes(fq)
    (d / "in.fa").write_bytes(fa)
    (d / "empty.fq").write_bytes(b"")
    with gzip.open(d / "in.fq.gz", "wb") as f:
        f.write(fq)
    return d


@pytest.mark.parametrize("quality", [True, False])
@pytest.mark.parametrize("name", ["in.fq", "in.fa"])
def test_regular_file_is_parsed_from_a_mapping_gone_on_return(files, name, quality,
                                                              monkeypatch):
    path = str(files / name)
    fmt = SequenceFormat.AUTO.resolve(path)
    monkeypatch.setenv("KRUST_NATIVE_THREADS", "3")
    streams, threads, mapped = reader.read_streams(path, fmt, quality=quality)
    assert (threads, mapped) == (3, True)
    assert _maps_of(path) == []
    want = reader.parse_to_streams(open(path, "rb").read(), fmt, quality=quality)
    np.testing.assert_array_equal(streams.codes, want.codes)
    assert (streams.n_records, streams.n_bases) == (want.n_records, want.n_bases)
    if want.qual is None:
        assert streams.qual is None
    else:
        np.testing.assert_array_equal(streams.qual, want.qual)
    assert all(_owns(a) for a in (streams.codes, streams.qual) if a is not None)


def test_the_mapping_is_gone_after_a_format_error(tmp_path):
    path = tmp_path / "bad.fq"
    path.write_bytes(ERRORS[4][1])
    with pytest.raises(FormatError, match="separator"):
        reader.read_streams(str(path), SequenceFormat.FASTQ)
    assert _maps_of(path) == []


def _fifo_streams(tmp_path, data):
    fifo = str(tmp_path / "in.fq")
    os.mkfifo(fifo)

    def write():
        with open(fifo, "wb") as f:
            f.write(data)

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    try:
        return reader.read_streams(fifo, SequenceFormat.AUTO, quality=False)
    finally:
        writer.join(timeout=30)
        assert not writer.is_alive()


@pytest.mark.parametrize("kind", ["gzip", "empty", "fifo", "stdin"])
def test_other_inputs_are_read(files, tmp_path, kind, monkeypatch):
    """gzip, an empty file, a FIFO and stdin take the read path (nothing
    mapped) and parse as the bytes they hold."""
    data = b"" if kind == "empty" else CASES["fq_many"][1]
    if kind == "fifo":
        streams, threads, mapped = _fifo_streams(tmp_path, data)
    else:
        if kind == "stdin":
            monkeypatch.setattr(sys, "stdin", _Stdin(data))
        path = {"gzip": str(files / "in.fq.gz"), "empty": str(files / "empty.fq"),
                "stdin": None}[kind]
        streams, threads, mapped = reader.read_streams(path, SequenceFormat.FASTQ,
                                                       quality=False)
    assert not mapped and threads == 1 and streams.qual is None
    want = reader.parse_to_streams(data, SequenceFormat.FASTQ)
    np.testing.assert_array_equal(streams.codes, want.codes)
    assert (streams.n_records, streams.n_bases) == (want.n_records, want.n_bases)


def test_read_errors_are_the_reads(tmp_path):
    with pytest.raises(FileNotFoundError):
        reader.read_streams(str(tmp_path / "missing.fq"), SequenceFormat.FASTQ)
    with pytest.raises(ReadError):
        reader.read_streams(str(tmp_path), SequenceFormat.FASTQ)
    with pytest.raises(ReadError):
        reader.read_input_bytes(str(tmp_path))


def _spans(fn):
    seen = []

    def collect(kind, name, fields):
        if kind == "span" and name == "read_sequences":
            seen.append(fields)

    tracing.add_collector(collect)
    try:
        result = fn()
    finally:
        tracing.remove_collector(collect)
    return result, seen


_JAX_CACHE: dict = {}


def _jax_count(path, k, q):
    key = (path, k, q)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = jax_api._count_path(path, k, JaxFormat.AUTO, q,
                                              jax_config.EngineConfig(**GEOMETRY))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("q", [None, 20], ids=["q0", "q20"])
@pytest.mark.parametrize("name", ["in.fq", "in.fa"])
def test_counts_are_krust_tpus_and_the_span_says_how(files, name, q, monkeypatch):
    """The count over the new read path equals ``krust_tpu``'s, one device
    and over two CPU slots, and ``read_sequences`` carries ``threads``,
    ``mapped`` and ``quality`` (a quality stream only for -Q on FASTQ)."""
    path = str(files / name)
    monkeypatch.setattr(native, "INGEST_PART_BYTES", 1 << 10)
    monkeypatch.delenv("KRUST_NATIVE_THREADS", raising=False)
    want = _jax_count(path, 21, q)
    cfg = EngineConfig(device="cpu", **GEOMETRY)
    got, seen = _spans(lambda: port_api._count_path(path, 21, SequenceFormat.AUTO, q, cfg))
    sharded, seen_sharded = _spans(lambda: port_api.count_kmers_sharded_result(
        path, 21, SequenceFormat.AUTO, q, mesh=make_mesh(devices=["cpu"] * 2)))
    for result in (got, sharded):
        np.testing.assert_array_equal(result.codes, want.codes)
        np.testing.assert_array_equal(result.counts, want.counts)
    threads = min(native.INGEST_MAX_THREADS, len(os.sched_getaffinity(0)),
                  -(-os.path.getsize(path) // native.INGEST_PART_BYTES))
    quality = name == "in.fq" and q is not None
    for fields in seen + seen_sharded:
        assert (fields["threads"], fields["mapped"], fields["quality"]) == (
            threads, True, quality)
    assert len(seen) == len(seen_sharded) == 1


def test_stdin_count_reads_and_counts_as_before(files, monkeypatch):
    """An eager stdin count (``ingest_chunk_bytes=0``) takes the read path:
    the span says nothing was mapped; the table is krust_tpu's."""
    data = CASES["fq_many"][1]
    monkeypatch.setattr(sys, "stdin", _Stdin(data))
    cfg = EngineConfig(device="cpu", ingest_chunk_bytes=0, **GEOMETRY)
    got, seen = _spans(lambda: port_api._count_path(None, 21, SequenceFormat.FASTQ, None,
                                                    cfg))
    want = _jax_count(str(files / "in.fq"), 21, None)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert [(f["mapped"], f["quality"]) for f in seen] == [(False, False)]
