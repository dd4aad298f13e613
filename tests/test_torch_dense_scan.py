"""The route scan that packs: ``io/packer.scan_stream`` over the native
``krust_scan_pack`` (``io/native/ingest.cpp``).

A threaded pass over a code stream counts its invalid bases exactly, which
decides the route (flat while they are at most ``n // 32``); a second
writes every base's 2-bit byte and either the invalid positions (flat) or
the invalid mask (dense), both arrays then padded to the rows
``pack_buffer_2bit`` cuts from them (``prepacked=``). Held here on the
CPU:

- the native dense pack, with and without a scan before it, byte-equal to
  numpy's ``pack_stream_2bit``: every length mod 8, ``-Q`` on and off, an
  all-bad and an empty stream, 1/2/3/7/8 forced threads, N runs inside one
  thread's range;
- the route at ``n // 32`` invalid bases and one more, against the old
  rule and ``krust_tpu``'s ``flat_batches``, and ``route_batches``' batches
  on both routes against ``krust_tpu``'s; a scan past its budget that asks
  for no mask writes nothing;
- a flat stream's ``packed2`` and ``invpos`` against the core's
  ``krust_scan_stream``;
- ``pack_buffer_2bit``'s batches from ``prepacked=`` against
  ``krust_tpu``'s;
- the ``flat_scan`` span's ``route``, ``invalid`` and ``threads`` and the
  ``packer.dense_packs`` counter through ``BatchEngine``;
- counts of a GRCh38-shaped genome from ``portbench/gen.py`` (the dense
  route) at k = 15 and 31 against ``krust_tpu``'s and the benchmark's
  plain reference.
"""

import numpy as np
import pytest
import torch

from krust_tpu.io import packer as jax_packer
from krust_tpu.io.format import SequenceFormat as JaxFormat
from krust_tpu.io.reader import parse_to_streams as jax_parse
from krust_tpu.models.engines import NumpyEngine as JaxNumpyEngine
from krust_tpu_torch import api
from krust_tpu_torch.io import native, packer
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.io.input import Input
from krust_tpu_torch.io.reader import ParsedStreams, read_input_bytes
from krust_tpu_torch.kmer import INVALID_CODE
from krust_tpu_torch.models.engines import BatchEngine
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig
from portbench import gen, reference

THREADS = [1, 2, 3, 7, 8]
THR = 53  # -Q 20


def _stream(n, seed, n_share=0.05, quality=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.random(n) < n_share] = INVALID_CODE
    qual = rng.integers(33, 74, n, dtype=np.uint8) if quality else None
    return codes, qual


def _bad(codes, qual):
    bad = codes >= INVALID_CODE
    return bad | (qual < THR) if qual is not None else bad


def _numpy_pack(codes, qual):
    """numpy's pack cut to the stream's own bytes (it pads an empty one)."""
    p2, bb = packer.pack_stream_2bit(codes, qual, THR if qual is not None else None)
    n = codes.shape[0]
    return p2[: -(-n // 4)], bb[: -(-n // 8)]


def _assert_dense_equals_numpy(scan, codes, qual, need4, need8):
    n = codes.shape[0]
    p2, bb = _numpy_pack(codes, qual)
    assert scan.route == "dense" and scan.invpos is None
    assert scan.n_invalid == int(_bad(codes, qual).sum())
    assert scan.packed2.shape[0] == max(need4, -(-n // 4))
    assert scan.badbits.shape[0] == max(need8, -(-n // 8))
    np.testing.assert_array_equal(scan.packed2[: p2.shape[0]], p2)
    np.testing.assert_array_equal(scan.badbits[: bb.shape[0]], bb)
    assert not scan.packed2[p2.shape[0]:].any()
    assert (scan.badbits[bb.shape[0]:] == 0xFF).all()


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("quality", [False, True], ids=["no-q", "q20"])
@pytest.mark.parametrize("n_mod", range(8))
@pytest.mark.parametrize("scanned", [False, True], ids=["pack", "scan"])
def test_dense_pack_matches_numpy(monkeypatch, scanned, n_mod, quality, threads):
    """The dense pack (one pass, ``max_inv < 0``) and the scan that ends
    dense (the count's pass, then the pack's) write numpy's bytes and the
    padding."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", str(threads))
    codes, qual = _stream(8 * 257 + n_mod, 10 * n_mod + threads, 0.06)
    thr = THR if quality else None
    q = qual if quality else None
    k, w = 21, 64
    need4, need8 = packer._dense_lengths(codes.shape[0], k, w)
    scan = packer.scan_stream(codes, q, thr, 0 if scanned else -1, k, w)
    assert scan.threads == threads
    _assert_dense_equals_numpy(scan, codes, q, need4, need8)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1003])
def test_all_bad_and_empty_streams(monkeypatch, n, threads):
    """An all-bad stream packs every base's ``code & 3`` and a full mask; an
    empty stream packs nothing, pads, and scans flat with no position."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", str(threads))
    codes = np.full(n, INVALID_CODE, np.uint8)
    need4, need8 = packer._dense_lengths(n, 5, 16)
    scan = packer.scan_stream(codes, None, None, -1, 5, 16)
    _assert_dense_equals_numpy(scan, codes, None, need4, need8)
    assert scan.n_invalid == n
    flat = packer.scan_stream(codes, None, None, n, 5, 16)
    assert flat.route == "flat" and flat.invpos.tolist() == list(range(n))
    core = native.scan_stream_native(codes, None, None, n)
    np.testing.assert_array_equal(flat.packed2, core[0])
    np.testing.assert_array_equal(flat.invpos, core[1])


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("budget", ["fits", "passes"])
def test_n_runs_in_one_range(monkeypatch, budget, threads):
    """Every invalid base in one run inside one thread's range: that range
    writes them all at its offset while they fit ``max_inv``; one more and
    the scan writes no position, packs, counts and ends dense."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", str(threads))
    n = 64 * 1024 + 5
    codes, _ = _stream(n, 40 + threads, 0.0)
    at = n * (threads - 1) // threads + 3  # inside the last thread's range
    run = n // 32 if budget == "fits" else n // 32 + 1
    codes[at:at + run] = INVALID_CODE
    scan = packer.scan_stream(codes, None, None, n // 32, 17, 128)
    assert scan.n_invalid == run
    if budget == "fits":
        assert scan.route == "flat"
        np.testing.assert_array_equal(scan.invpos, np.arange(at, at + run))
        core = native.scan_stream_native(codes, None, None, n // 32)
        np.testing.assert_array_equal(scan.packed2, core[0])
    else:
        need4, need8 = packer._dense_lengths(n, 17, 128)
        _assert_dense_equals_numpy(scan, codes, None, need4, need8)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("quality", [False, True], ids=["no-q", "q20"])
@pytest.mark.parametrize("extra", [0, 1], ids=["at-the-gate", "one-more"])
def test_route_at_the_gate(monkeypatch, extra, quality, threads):
    """``n // 32`` invalid bases (Ns, or with -Q quality below the
    threshold) scan flat, one more dense: the old rule, and krust_tpu's."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", str(threads))
    n = 32 * 300 + 11
    rng = np.random.default_rng(70 + threads)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    qual = np.full(n, 70, np.uint8)
    where = rng.choice(n, n // 32 + extra, replace=False)
    if quality:
        qual[where[::2]] = 40
        codes[where[1::2]] = INVALID_CODE
    else:
        codes[where] = INVALID_CODE
    q, thr = (qual, THR) if quality else (None, None)
    scan = packer.scan_stream(codes, q, thr, n // 32, 11, 256)
    assert scan.n_invalid == n // 32 + extra
    assert scan.route == ("dense" if extra else "flat")
    assert (packer.flat_scan(codes, q, thr, n // 32) is None) == bool(extra)
    assert (jax_packer.flat_batches(codes, q, 11, thr, 256, 8) is None) == bool(extra)
    if not extra:
        np.testing.assert_array_equal(scan.invpos, np.sort(where))


def _assert_batches_equal(got, exp):
    got, exp = list(got), list(exp)
    assert len(got) == len(exp) and type(got[0]).__name__ == type(exp[0]).__name__
    for g, e in zip(got, exp):
        for name, value in vars(e).items():
            np.testing.assert_array_equal(getattr(g, name), value, err_msg=name)


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("k,w", [(11, 256), (31, 24)], ids=["eligible", "ineligible"])
@pytest.mark.parametrize("extra", [0, 1], ids=["at-the-gate", "one-more"])
def test_route_batches_picks_the_route(monkeypatch, extra, k, w, threads):
    """``route_batches`` routes flat at ``n // 32`` invalid bases on a
    geometry the flat layout holds, and dense past it or on any other
    geometry; its batches are ``krust_tpu``'s byte for byte, and its scan
    the one the span reads."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", str(threads))
    n = 32 * 300 + 5
    rng = np.random.default_rng(110 + threads)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.choice(n, n // 32 + extra, replace=False)] = INVALID_CODE
    scan, batches = packer.route_batches(codes, None, k, None, w, 8)
    dense = bool(extra) or w < k - 1
    assert scan.route == ("dense" if dense else "flat")
    assert scan.n_invalid == n // 32 + extra and scan.threads == threads
    if dense:
        _assert_batches_equal(batches, jax_packer.pack_buffer_2bit(codes, None, k, None, w, 8))
    else:
        _assert_batches_equal(batches, jax_packer.flat_batches(codes, None, k, None, w, 8))


@pytest.mark.parametrize("threads", THREADS)
def test_dense_scan_without_a_mask_packs_nothing(monkeypatch, threads):
    """A scan past its budget that asks for no mask (no ``k``) counts the
    invalid bases exactly and writes nothing: no 2-bit bytes, no
    positions, no mask."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", str(threads))
    codes, _ = _stream(8 * 999 + 3, 130 + threads, 0.1)
    n_bad = int((codes >= INVALID_CODE).sum())
    packed2, invpos, badbits, n_inv, used = native.scan_pack_native(
        codes, None, None, codes.shape[0] // 32)
    assert (packed2, invpos, badbits, n_inv, used) == (None, None, None, n_bad, threads)
    scan = packer.scan_stream(codes, None, None, codes.shape[0] // 32)
    assert scan.route == "dense" and scan.n_invalid == n_bad and scan.prepacked is None
    assert packer.flat_scan(codes, None, None, codes.shape[0] // 32) is None


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("quality", [False, True], ids=["no-q", "q20"])
def test_flat_scan_equals_the_core_scan(monkeypatch, quality, threads):
    """A flat stream's ``packed2`` and ``invpos`` are the core's
    ``krust_scan_stream``'s, byte for byte, at the engine's padded
    allocation too."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", str(threads))
    codes, qual = _stream(100_003, 90 + threads, 0.004, quality)
    if quality:
        qual[qual < THR] = THR  # the quality fold: only a few bases below it
        qual[::211] = 35
    q, thr = (qual, THR) if quality else (None, None)
    core = native.scan_stream_native(codes, q, thr, codes.shape[0] // 32)
    for k in (None, 21):
        scan = packer.scan_stream(codes, q, thr, codes.shape[0] // 32, k, 4096)
        assert scan.route == "flat" and scan.badbits is None and scan.prepacked is None
        np.testing.assert_array_equal(scan.packed2, core[0])
        np.testing.assert_array_equal(scan.invpos, core[1])
        assert scan.n_invalid == core[2]


@pytest.mark.parametrize("quality", [False, True], ids=["no-q", "q20"])
@pytest.mark.parametrize("k,w,rows", [(1, 8, 3), (15, 64, 4), (21, 128, None), (32, 24, 2)])
def test_prepacked_batches_equal_krust_tpu(quality, k, w, rows):
    """The rows cut from a dense scan's arrays, and the packer's own native
    pack, are ``krust_tpu``'s batches byte for byte."""
    codes, qual = _stream(5 * w * 8 + 13, k + w, 0.07, quality)
    thr = THR if quality else None
    scan = packer.scan_stream(codes, qual, thr, codes.shape[0] // 32, k, w)
    assert scan.route == "dense"
    exp = list(jax_packer.pack_buffer_2bit(codes, qual, k, thr, w, rows))
    for prepacked in (scan.prepacked, None):
        got = list(packer.pack_buffer_2bit(codes, qual, k, thr, w, rows,
                                           prepacked=prepacked))
        assert len(got) == len(exp)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.packed2, e.packed2)
            np.testing.assert_array_equal(g.badbits, e.badbits)
            assert (g.n_windows, g.block_windows, g.width) == (
                e.n_windows, e.block_windows, e.width)


def test_prepacked_arrays_too_short_raise():
    codes, _ = _stream(4000, 3, 0.1)
    scan = packer.scan_stream(codes, None, None, 0, 21, 64)
    with pytest.raises(ValueError, match="shorter"):
        next(packer.pack_buffer_2bit(codes, None, 31, None, 64, prepacked=scan.prepacked))


@pytest.mark.parametrize("use_flat", [True, False], ids=["scan", "no-scan"])
@pytest.mark.parametrize("route,n_share", [("flat", 0.002), ("dense", 0.08)])
def test_flat_scan_span_and_dense_counter(monkeypatch, route, n_share, use_flat):
    """``flat_scan`` carries the route taken, the exact invalid count and
    the scan's threads; ``packer.dense_packs`` counts one whole-stream pack
    a dense count, made by the scan or, without one, by the packer."""
    monkeypatch.setenv("KRUST_NATIVE_THREADS", "3")
    codes, _ = _stream(40_000, 5, n_share)
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    spans = []

    def collect(kind, name, fields):
        if kind == "span" and name == "flat_scan":
            spans.append(fields)

    packs = packer.dense_packs
    tracing.add_collector(collect)
    try:
        cfg = EngineConfig(block_windows=256, batch_rows=8, device="cpu", use_flat=use_flat)
        BatchEngine(cfg).count(streams, 13)
    finally:
        tracing.remove_collector(collect)
    dense = route == "dense" or not use_flat
    assert packer.dense_packs - packs == int(dense)
    if not use_flat:
        assert spans == []
        return
    (fields,) = spans
    assert fields["route"] == route
    assert fields["invalid"] == int((codes >= INVALID_CODE).sum())
    assert fields["threads"] == 3


def test_ineligible_geometry_packs_in_the_scan(monkeypatch):
    """A block the flat layout cannot hold (``block_windows < k - 1``)
    routes dense without a budget: the scan's one pass packs both arrays."""
    codes, _ = _stream(20_000, 6, 0.001)
    streams = ParsedStreams(codes, None, 1, codes.shape[0])
    spans = []
    collect = lambda kind, name, f: spans.append(f) if name == "flat_scan" else None  # noqa: E731
    packs = packer.dense_packs
    tracing.add_collector(collect)
    try:
        got = BatchEngine(EngineConfig(block_windows=8, batch_rows=8, device="cpu")).count(
            streams, 21)
    finally:
        tracing.remove_collector(collect)
    assert packer.dense_packs - packs == 1
    assert [f["route"] for f in spans] == ["dense"]
    fasta = b">r\n" + np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes()
    exp = JaxNumpyEngine().count(jax_parse(fasta, JaxFormat.FASTA), 21)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    path = tmp_path_factory.mktemp("dense_scan") / "grch38.fa"
    gen.write_genome(str(path), 2**31 + 271, torch.device("cpu"), total_bases=400_000,
                     line=60, n_run=[2_000, 20_000], n_share=0.049,
                     repeats=[{"class": "LINE", "share": 0.2, "mean_length": 644,
                               "consensus_length": 6000}],
                     divergence=[0.0, 0.35])
    return str(path)


@pytest.mark.parametrize("k", [15, 31])
def test_genome_counts_match_krust_tpu_and_the_reference(genome, k):
    """A GRCh38-shaped genome (4.9% N in runs) takes the dense route from
    the scan's arrays, and counts as krust_tpu and the plain reference do."""
    spans = []
    collect = lambda kind, name, f: spans.append(f) if name == "flat_scan" else None  # noqa: E731
    packs = packer.dense_packs
    tracing.add_collector(collect)
    try:
        got = api.count_with_input(Input.from_path(genome), k, SequenceFormat.AUTO, None,
                                   EngineConfig(device="cpu", block_windows=1024,
                                                batch_rows=16))
    finally:
        tracing.remove_collector(collect)
    assert [f["route"] for f in spans] == ["dense"]
    assert packer.dense_packs - packs == 1
    exp = JaxNumpyEngine().count(jax_parse(read_input_bytes(genome), JaxFormat.FASTA), k)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    data = torch.from_numpy(np.fromfile(genome, np.uint8))
    keys, counts = reference.count_table(data, False, k, None)
    np.testing.assert_array_equal(got.codes, reference.codes_of(keys).numpy().view(np.uint64))
    np.testing.assert_array_equal(got.counts, counts.numpy().astype(np.uint64))
