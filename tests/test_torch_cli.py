"""The port's CLI, output, histogram and ``.kmix`` index against krust_tpu's.

``krust_tpu_torch.cli.main`` runs in process, counting on the port's device
engine on the CPU (every kernel's plain version, small batches and
epochs), against ``krust_tpu.cli.main`` on its XLA-CPU device engine:

- the four output formats x ``--min-count`` {1, 2} x the six
  ``tests/fixtures/`` files x k in {1, 5, 21, 32} (FASTQ at -Q 20), with
  the banner on stderr;
- ``--save``: the ``.kmix`` bytes equal, then ``query`` of each index by
  both CLIs, with case folding and reverse-complement folding;
- stdin, and every error path: the same exit code and the same message;
- ``serialize_index``, ``format_packed_counts``, ``output_counts``,
  ``compute_histogram*`` and ``histogram_stats`` on equal inputs.

Equal bytes everywhere. The one stated difference is the banner's reader
name (``krust-tpu-torch`` where krust_tpu prints ``krust-tpu``).
"""

import io
import os
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest

import krust_tpu.cli as jax_cli
import krust_tpu.histogram as jax_hist
import krust_tpu.index as jax_index
import krust_tpu.output as jax_output
import krust_tpu_torch.cli as port_cli
import krust_tpu_torch.histogram as port_hist
import krust_tpu_torch.index as port_index
import krust_tpu_torch.output as port_output
from krust_tpu_torch.models import engines
from krust_tpu_torch.ops import table as table_mod

FIXTURES = ["simple.fa", "simple.fq", "with_n.fa", "with_n.fq", "soft_masked.fa",
            "low_quality.fq"]
FORMATS = ["fasta", "tsv", "json", "histogram"]
GEOMETRY = dict(block_windows=256, batch_rows=8)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def port_on_cpu_device(monkeypatch):
    """Every port count runs the device engine on the CPU, small epochs."""
    used = []

    def select(cfg):
        used.append(cfg)
        return engines.BatchEngine(replace(cfg, device="cpu", **GEOMETRY))

    monkeypatch.setattr(engines, "select_engine", select)
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "700")
    return used


class _Stdin:
    def __init__(self, data: bytes):
        self.buffer = io.BytesIO(data)


def _run(cli, argv, capsysbinary, monkeypatch, stdin=None):
    """(exit code, stdout, stderr) of ``cli.main(argv)`` in process."""
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", _Stdin(stdin))
    try:
        rc = cli.main(list(argv))
    except SystemExit as e:
        rc = e.code
    out = capsysbinary.readouterr()
    return rc, out.out, out.err


def _both(argv, capsysbinary, monkeypatch, stdin=None):
    """Run both CLIs; assert equal exit codes and bytes; return the port's."""
    got = _run(port_cli, argv, capsysbinary, monkeypatch, stdin)
    exp = _run(jax_cli, argv, capsysbinary, monkeypatch, stdin)
    assert got[0] == exp[0], (got, exp)
    assert got[1] == exp[1]
    assert got[2].replace(b"krust-tpu-torch", b"krust-tpu") == exp[2]
    return got


@pytest.mark.parametrize("k", [1, 5, 21, 32])
@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("fmt", FORMATS)
def test_count_formats_match_krust_tpu(fixtures_dir, capsysbinary, monkeypatch,
                                       port_on_cpu_device, fmt, min_count, name, k):
    argv = [str(k), str(fixtures_dir / name), "-f", fmt, "-m", str(min_count)]
    if name.endswith(".fq"):
        argv += ["-Q", "20"]
    rc, out, err = _both(argv, capsysbinary, monkeypatch)
    assert rc == 0 and port_on_cpu_device
    assert b"k-length" in err and b"krust-tpu-torch" in err


def test_counts_take_merges(fixtures_dir, capsysbinary, monkeypatch):
    """Batches of 8 windows and an epoch a batch make a fixture's count
    flush several epochs and merge their parts."""
    merges = []
    real = table_mod._merge_compact
    monkeypatch.setattr(table_mod, "_merge_compact",
                        lambda *a: merges.append(1) or real(*a))
    monkeypatch.setattr(engines, "select_engine", lambda cfg: engines.BatchEngine(
        replace(cfg, device="cpu", block_windows=8, batch_rows=1)))
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "1")
    _both(["3", str(fixtures_dir / "with_n.fa"), "-f", "tsv", "-q"], capsysbinary,
          monkeypatch)
    assert merges


@pytest.mark.parametrize("k", [5, 21])
@pytest.mark.parametrize("name", ["simple.fa", "with_n.fq", "soft_masked.fa"])
def test_save_and_query_match_krust_tpu(fixtures_dir, tmp_path, capsysbinary,
                                        monkeypatch, name, k):
    """``--save`` writes the same ``.kmix`` bytes; each CLI answers the same
    queries on either index: present k-mers in lower case and as their
    reverse complement, and an absent one."""
    path = str(fixtures_dir / name)
    saved = tmp_path / "x.kmix"  # one path: the banner names it
    argv = [str(k), path, "--save", str(saved), "-f", "tsv"]
    got = _run(port_cli, argv, capsysbinary, monkeypatch)
    port_kmix = tmp_path / "port.kmix"
    saved.rename(port_kmix)
    exp = _run(jax_cli, argv, capsysbinary, monkeypatch)
    jax_kmix = tmp_path / "jax.kmix"
    saved.rename(jax_kmix)
    assert got[0] == exp[0] == 0 and got[1] == exp[1]
    assert got[2].replace(b"krust-tpu-torch", b"krust-tpu") == exp[2]
    assert b"saved" in got[2]
    assert port_kmix.read_bytes() == jax_kmix.read_bytes()

    comp = str.maketrans("ACGT", "TGCA")
    kmers = [line.split("\t")[0] for line in got[1].decode().splitlines()]
    queries = [q for km in kmers[:3] for q in (km.lower(), km.translate(comp)[::-1])]
    queries.append("A" * k if "A" * k not in kmers else "C" * k)
    if not kmers:
        queries = ["a" * k, "G" * k]
    for index in (port_kmix, jax_kmix):
        for q in queries:
            rc, out, _ = _both(["query", str(index), q], capsysbinary, monkeypatch)
            assert rc == 0 and int(out) >= 0
    if kmers:
        counts = dict(line.split("\t") for line in got[1].decode().splitlines())
        rc, out, _ = _run(port_cli, ["query", str(port_kmix), kmers[0].lower()],
                          capsysbinary, monkeypatch)
        assert int(out) == int(counts[kmers[0]])


@pytest.mark.parametrize(
    "argv,data",
    [(["5"], b">a\nACGTACGTNNACGT\n>b\nTTTTTTTT\n"),
     (["5", "-", "-f", "json"], b">a\nACGTACGTNNACGT\n>b\nTTTTTTTT\n"),
     (["3", "-", "-f", "histogram", "-m", "2"], b">a\nACGTACGTNNACGTacgt\n"),
     (["7", "-i", "fastq", "-f", "tsv"], b"@r\nACGTACGTAAC\n+\nIIIII#IIIII\n"),
     (["7", "-", "-i", "fastq", "-f", "tsv", "-Q", "20"],
      b"@r\nACGTACGTAAC\n+\nIIIII#IIIII\n"),
     (["4", "-", "-f", "tsv", "-q"], b"")],
    ids=["fasta_default", "json", "histogram", "fastq", "fastq_q_warning", "empty"],
)
def test_stdin_matches_krust_tpu(capsysbinary, monkeypatch, port_on_cpu_device, argv,
                                 data):
    """Stdin (the chunked path) in both CLIs: equal output and banner,
    the ``-Q`` warning for stdin included."""
    rc, out, _ = _both(argv, capsysbinary, monkeypatch, stdin=data)
    assert rc == 0 and port_on_cpu_device


def _corrupt_index(tmp_path):
    path = tmp_path / "x.kmix"
    index = port_index.KmerIndex.from_arrays(5, np.array([3, 9], np.uint64),
                                             np.array([2, 7], np.uint64))
    raw = bytearray(port_index.serialize_index(index))
    raw[20] ^= 0xFF
    path.write_bytes(bytes(raw))
    return path


@pytest.mark.parametrize(
    "case",
    ["k_zero", "k_33", "k_not_a_number", "k_negative", "missing_file",
     "min_count_negative", "min_quality_94", "fasta_without_header",
     "fastq_length_mismatch", "query_corrupt_index", "query_missing_index",
     "query_wrong_length", "query_bad_base", "no_args", "version"],
)
def test_error_paths_match_krust_tpu(fixtures_dir, tmp_path, capsysbinary, monkeypatch,
                                     case):
    """The same exit code and the same message on stderr."""
    simple = str(fixtures_dir / "simple.fa")
    kmix = tmp_path / "ok.kmix"
    port_index.save_index(port_index.KmerIndex.from_arrays(
        5, np.array([27], np.uint64), np.array([4], np.uint64)), kmix)
    bad_fa = tmp_path / "bad.fa"
    bad_fa.write_bytes(b"ACGT\n>r\nACGT\n")
    bad_fq = tmp_path / "bad.fq"
    bad_fq.write_bytes(b"@r\nACGTA\n+\nIII\n")
    argv = {
        "k_zero": ["0", simple],
        "k_33": ["33", simple],
        "k_not_a_number": ["abc", simple],
        "k_negative": ["-3", simple],
        "missing_file": ["5", str(tmp_path / "absent.fa")],
        "min_count_negative": ["5", simple, "-m", "-1"],
        "min_quality_94": ["5", simple, "-Q", "94"],
        "fasta_without_header": ["3", str(bad_fa)],
        "fastq_length_mismatch": ["3", str(bad_fq), "-q"],
        "query_corrupt_index": ["query", str(_corrupt_index(tmp_path)), "ACGTA"],
        "query_missing_index": ["query", str(tmp_path / "absent.kmix"), "ACGTA"],
        "query_wrong_length": ["query", str(kmix), "ACGT"],
        "query_bad_base": ["query", str(kmix), "ACGTN"],
        "no_args": [],
        "version": ["--version"],
    }[case]
    rc, out, err = _both(argv, capsysbinary, monkeypatch)
    if case == "version":
        assert rc == 0 and out.startswith(b"kmix ")
    else:
        assert rc in (1, 2) and err


def _random_counts(seed, n, k):
    rng = np.random.default_rng(seed)
    hi = 1 << (2 * k)
    codes = np.unique(rng.integers(0, hi, n, dtype=np.uint64) if k < 32
                      else rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2))
    counts = rng.choice(np.array([1, 1, 1, 2, 3, 9, 10, 99, 100, 12345678901], np.uint64),
                        codes.shape[0])
    return codes, counts


@pytest.mark.parametrize("min_count", [0, 1, 2, 10])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("k", [1, 5, 21, 32])
def test_format_packed_counts_matches_krust_tpu(k, fmt, min_count):
    codes, counts = _random_counts(k, 300, k)
    got = port_output.format_packed_counts(codes, counts, k,
                                           port_output.OutputFormat(fmt), min_count)
    exp = jax_output.format_packed_counts(codes, counts, k,
                                          jax_output.OutputFormat(fmt), min_count)
    assert got == exp
    empty = np.zeros(0, np.uint64)
    assert port_output.format_packed_counts(
        empty, empty, k, port_output.OutputFormat(fmt), min_count
    ) == jax_output.format_packed_counts(
        empty, empty, k, jax_output.OutputFormat(fmt), min_count)


@pytest.mark.parametrize("min_count", [1, 2])
@pytest.mark.parametrize("fmt", FORMATS)
def test_output_counts_matches_krust_tpu(fmt, min_count):
    """The string-keyed writer, to a text stream and to stdout."""
    from krust_tpu_torch.kmer import unpack_many

    codes, counts = _random_counts(3, 100, 9)
    strings = dict(zip(unpack_many(codes, 9), counts.tolist()))
    got, exp = io.StringIO(), io.StringIO()
    port_output.output_counts(strings, port_output.OutputFormat(fmt), min_count, got)
    jax_output.output_counts(strings, jax_output.OutputFormat(fmt), min_count, exp)
    assert got.getvalue() == exp.getvalue() and got.getvalue()


@pytest.mark.parametrize("k", [1, 5, 21, 32])
@pytest.mark.parametrize("n", [0, 1, 500])
def test_index_bytes_and_lookups_match_krust_tpu(tmp_path, k, n):
    """``serialize_index`` bytes, a gzip round trip, and ``get``."""
    codes, counts = _random_counts(k + n, n, k)
    port = port_index.KmerIndex.from_arrays(k, codes, counts)
    ref = jax_index.KmerIndex.from_arrays(k, codes, counts)
    raw = port_index.serialize_index(port)
    assert raw == jax_index.serialize_index(ref)
    port_index.save_index(port, tmp_path / "p.kmix.gz")
    loaded = jax_index.load_index(tmp_path / "p.kmix.gz")
    back = port_index.deserialize_index(raw)
    assert back.k.get() == loaded.k.get() == k
    np.testing.assert_array_equal(back.codes, loaded.codes)
    np.testing.assert_array_equal(back.values, loaded.values)
    for c in codes[:50].tolist() + [int(codes.max()) + 1 if n else 7]:
        assert back.get(c) == ref.get(c)
    assert back.counts == ref.counts


@pytest.mark.parametrize("damage", ["crc", "magic", "version", "k", "short", "size"])
def test_index_errors_match_krust_tpu(damage):
    codes, counts = _random_counts(1, 20, 7)
    raw = bytearray(port_index.serialize_index(
        port_index.KmerIndex.from_arrays(7, codes, counts)))
    if damage == "crc":
        raw[30] ^= 1
    elif damage == "magic":
        raw[0:4] = b"KMIY"
    elif damage == "short":
        raw = raw[:10]
    else:
        raw[{"version": 4, "k": 5, "size": 6}[damage]] = 99
        raw = raw[:-4] + port_index.zlib.crc32(bytes(raw[:-4])).to_bytes(4, "little")
    with pytest.raises(Exception) as got:
        port_index.deserialize_index(bytes(raw))
    with pytest.raises(Exception) as exp:
        jax_index.deserialize_index(bytes(raw))
    assert type(got.value).__name__ == type(exp.value).__name__
    assert str(got.value) == str(exp.value)


@pytest.mark.parametrize("seed", range(4))
def test_histograms_match_krust_tpu(seed):
    codes, counts = _random_counts(seed, 200, 11)
    packed = dict(zip(codes.tolist(), counts.tolist()))
    strings = {str(c): v for c, v in packed.items()}
    assert port_hist.compute_histogram_array(counts) == \
        jax_hist.compute_histogram_array(counts)
    assert port_hist.compute_histogram_packed(packed) == \
        jax_hist.compute_histogram_packed(packed)
    hist = port_hist.compute_histogram(strings)
    assert hist == jax_hist.compute_histogram(strings)
    assert list(hist) == list(jax_hist.compute_histogram(strings))
    assert port_hist.histogram_stats(hist).__dict__ == \
        jax_hist.histogram_stats(hist).__dict__
    assert port_hist.histogram_stats({}).__dict__ == jax_hist.histogram_stats({}).__dict__


def test_console_script_names_the_ports_cli():
    """``pyproject.toml`` names ``kmix-torch`` -> ``krust_tpu_torch.cli:main``,
    and the name resolves to that function."""
    import importlib
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["kmix"] == "krust_tpu.cli:main"
    module, func = scripts["kmix-torch"].split(":")
    assert getattr(importlib.import_module(module), func) is port_cli.main
