"""K6's plain version and the histogram it carries to the output, on the CPU.

``ops.histogram.count_histogram_plain`` (the kernel's twin) against
``np.unique``; the histogram a table pull takes, carried by a
``PackedCounts`` of one table lifetime and formatted by ``output_packed``
with the same bytes as the host's ``compute_histogram_array`` path; none
on a count past one lifetime. The kernel itself is held to its twin in
``tests/test_torch_cuda.py`` on the card.
"""

import io

import numpy as np
import pytest
import torch

from krust_tpu_torch import api
from krust_tpu_torch.histogram import CountHistogram, compute_histogram_array
from krust_tpu_torch.io.format import SequenceFormat
from krust_tpu_torch.io.input import Input
from krust_tpu_torch.models.engines import BatchEngine, PackedCounts, _Lifetimes
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.histogram import BINS, count_histogram, count_histogram_plain
from krust_tpu_torch.output import OutputFormat, output_packed
from krust_tpu_torch.utils import tracing
from krust_tpu_torch.utils.config import EngineConfig

K = 15
GEOMETRY = dict(block_windows=256, batch_rows=8)


def _skewed(n, seed=3):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.3, n), 2**31 - 1).astype(np.int32)


COUNTS = {
    "empty": np.zeros(0, np.int32),
    "all_ones": np.ones(5000, np.int32),
    "skewed": _skewed(200_000),
    "bins_edge": np.array([BINS - 1, BINS, BINS + 1, BINS - 1, 1, BINS + 1, BINS], np.int32),
    "near_int32_max": np.array([2**31 - 1, 2**31 - 2, 1, 2**31 - 1, 7], np.int32),
    "skewed_past_bins": np.concatenate([_skewed(50_000, 5), np.arange(BINS - 3, BINS + 40,
                                                                      dtype=np.int32)]),
}


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_plain_version_equals_np_unique(case):
    counts = COUNTS[case]
    got = count_histogram_plain(torch.from_numpy(counts))
    values, freqs = np.unique(counts, return_counts=True)
    assert got.values.dtype == got.freqs.dtype == np.int64
    np.testing.assert_array_equal(got.values, values)
    np.testing.assert_array_equal(got.freqs, freqs)
    assert compute_histogram_array(got) == compute_histogram_array(counts.astype(np.uint64))


def test_a_cpu_tensor_runs_the_plain_version_and_launches_nothing():
    counts = torch.from_numpy(COUNTS["skewed"])
    before = count_histogram.launches
    got = count_histogram(counts)
    assert count_histogram.launches == before
    want = count_histogram_plain(counts)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.freqs, want.freqs)


@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("case", ["skewed", "bins_edge", "near_int32_max"])
def test_the_carried_histogram_gives_the_host_paths_bytes(case, min_count):
    counts = COUNTS[case].astype(np.uint64)
    codes = np.arange(counts.shape[0], dtype=np.uint64)
    hist = count_histogram_plain(torch.from_numpy(COUNTS[case]))
    carried = PackedCounts(K, codes, counts, hist)
    host = PackedCounts(K, codes, counts)
    assert carried == host  # the histogram takes no part in equality
    got, want = io.BytesIO(), io.BytesIO()
    output_packed(carried, OutputFormat.HISTOGRAM, min_count, out=got)
    output_packed(host, OutputFormat.HISTOGRAM, min_count, out=want)
    assert got.getvalue() == want.getvalue()
    kept = counts[counts >= min_count]
    np.testing.assert_array_equal(hist.at_least(min_count).values, np.unique(kept))


def _records(route, seed=11):
    rng = np.random.default_rng(seed)
    share = {"flat": 0.002, "dense": 0.08}[route]
    records = []
    for i in range(10):
        seq = rng.choice(np.array(list("ACGT")), 700 + 53 * i)
        seq[rng.random(seq.shape[0]) < share] = "N"
        # repeats, so that counts above 1 are common
        records.append("".join(seq) + "ACGTTGCAACGTTGCA" * (3 + i))
    return records


@pytest.fixture(params=["flat", "dense"])
def fasta(request, tmp_path):
    path = tmp_path / f"{request.param}.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(_records(request.param))))
    return str(path)


class _Sources:
    """The ``source`` field of every ``histogram`` span while installed."""

    def __init__(self):
        self.seen = []

    def __call__(self, kind, name, fields):
        if kind == "span" and name == "histogram":
            self.seen.append(fields["source"])

    def __enter__(self):
        tracing.add_collector(self)
        return self

    def __exit__(self, *exc):
        tracing.remove_collector(self)


def _count(path, **cfg):
    config = EngineConfig(device="cpu", **GEOMETRY, **cfg)
    return api.count_with_input(Input.from_path(path), K, SequenceFormat.AUTO, None, config)


def _histogram_bytes(result, min_count):
    sink = io.BytesIO()
    output_packed(result, OutputFormat.HISTOGRAM, min_count, out=sink)
    return sink.getvalue()


@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("cfg", [{}, {"use_flat": False}, {"use_epoch_sort": False}],
                         ids=["auto", "dense_forced", "lsm_table"])
def test_a_one_lifetime_count_carries_its_histogram(fasta, cfg, min_count, monkeypatch):
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    result = _count(fasta, **cfg)
    assert isinstance(result.histogram, CountHistogram)
    assert compute_histogram_array(result.histogram) == compute_histogram_array(result.counts)
    assert max(compute_histogram_array(result.counts)) > 1
    host = PackedCounts(result.k, result.codes, result.counts)
    with _Sources() as sources:
        got = _histogram_bytes(result, min_count)
        want = _histogram_bytes(host, min_count)
    assert sources.seen == ["device", "host"]
    assert got == want and got


def test_a_count_past_one_lifetime_carries_none(fasta, monkeypatch):
    monkeypatch.setenv("KRUST_PLATFORM", "cpu")
    one = _count(fasta)
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 3 * 8 * 256)
    pulls = []
    pull = table_mod._pull_table
    monkeypatch.setattr(table_mod, "_pull_table", lambda *a: pulls.append(1) or pull(*a))
    several = _count(fasta)
    assert len(pulls) > 1
    assert several.histogram is None
    np.testing.assert_array_equal(several.codes, one.codes)
    np.testing.assert_array_equal(several.counts, one.counts)
    with _Sources() as sources:
        got = _histogram_bytes(several, 1)
    assert sources.seen == ["host"]
    assert got == _histogram_bytes(one, 1)


def test_merge_epochs_keeps_only_one_pulled_tables_histogram(monkeypatch):
    class Pulls:  # a one-device table whose finalize hands out given pulled tables
        _device = torch.device("cpu")

        def __init__(self, *tables):
            self.finalize = iter(tables).__next__

    codes = np.array([3, 9], np.uint64)
    counts = np.array([2, 5], np.uint64)
    hist = count_histogram_plain(torch.tensor([2, 5], dtype=torch.int32))
    one = _Lifetimes(Pulls(table_mod.PulledTable(codes, counts, hist)), False).result(K)
    assert one.histogram is hist
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 1)  # a pull a batch
    for n in (2, 3):
        lifetimes = _Lifetimes(Pulls(*[table_mod.PulledTable(codes.copy(), counts.copy(), hist)
                                       for _ in range(n)]), False)
        for _ in range(n - 1):
            lifetimes.charge(1)
        several = lifetimes.result(K)
        assert several.histogram is None
        np.testing.assert_array_equal(several.counts, counts * n)


def test_a_pulled_table_unpacks_as_codes_and_counts():
    biased = (np.array([5, 7], np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    t_keys = torch.from_numpy(np.append(biased, np.int32(2**31 - 1)))
    t_cnt = torch.tensor([4, 1, 0], dtype=torch.int32)
    pulled = table_mod._pull_table(t_keys, t_cnt, 2, 8)
    codes, counts = pulled
    assert len(pulled) == 2
    np.testing.assert_array_equal(codes, np.array([5, 7], np.uint64))
    np.testing.assert_array_equal(counts, np.array([4, 1], np.uint64))
    np.testing.assert_array_equal(pulled.histogram.values, [1, 4])
    np.testing.assert_array_equal(pulled.histogram.freqs, [1, 1])


@pytest.mark.parametrize("slots", [1, 3])
def test_a_sharded_count_carries_its_pulled_tables_histogram(fasta, slots):
    from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes
    from krust_tpu_torch.parallel.mesh import make_mesh
    from krust_tpu_torch.parallel.sharded import count_sharded

    streams = parse_to_streams(read_input_bytes(fasta), SequenceFormat.FASTA)
    result = count_sharded(streams, K, mesh=make_mesh(devices=["cpu"] * slots),
                           config=EngineConfig(device="cpu", **GEOMETRY))
    assert result.histogram is not None
    assert compute_histogram_array(result.histogram) == compute_histogram_array(result.counts)
    assert _histogram_bytes(result, 1) == _histogram_bytes(
        PackedCounts(result.k, result.codes, result.counts), 1)
